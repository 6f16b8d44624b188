"""capture_s: seconds of the cell's graph capture (`graphs.capture_bootstrap`): the eager
warm-up, the capture and the instantiation, as the `GraphedBootstrap` counts them."""


def read(r):
    g = r.graphed
    if not g:
        return None
    return g["warmup_s"] + g["capture_s"] + g["instantiate_s"]
