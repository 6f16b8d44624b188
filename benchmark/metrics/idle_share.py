"""idle_share: the share of the window's wall time outside the bootstraps' graph replays:
1 - (sum over layers of the device time between CUDA events recorded just before and just
after the replay, its input copies and output clones with it) / window wall time, in %.
What it holds: each layer's gate affine on the device and every gap in which the device
waited for the host (the closed loop's synchronise, the next layer's issue)."""


def read(r):
    if not r.layer_busy_ms:
        return None
    return 100.0 * (1.0 - sum(r.layer_busy_ms) / 1e3 / r.window_s)
