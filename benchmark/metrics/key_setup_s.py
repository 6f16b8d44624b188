"""key_setup_s: seconds of the evaluator's key set-up (`kms.setup`: every party's keys
transformed into the evaluation domain), host clock, ending in a synchronise."""


def read(r):
    return r.key_setup_s
