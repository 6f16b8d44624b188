"""The traced summary's gap attribution: the one-pass walk gives every idle
gap the owner that a scan of the host ranges from the first gives it, on
synthetic gaps and nested, overlapping, touching and repeated host ranges."""

import random

import pytest

from benchmark import harness


def _scan(gaps, host):
    """Each gap's owner by a scan from the first host range: the last range
    in sorted order that began at or before the gap's start and ended at or
    after it."""
    host = sorted(host)
    owners = []
    for g0, _ in gaps:
        name = harness.OUTSIDE
        for h0, h1, hname in host:
            if h0 > g0:
                break
            if g0 <= h1:
                name = hname
        owners.append(name)
    return owners


def _case(rng, n_host, n_gaps, span):
    names = ["bench/issue", "bench/wait", "bench/ranges", "bench/x"]
    host = []
    for _ in range(n_host):
        h0 = rng.randrange(span)
        host.append((h0, h0 + rng.choice([0, 1, 5, rng.randrange(span // 4 + 1)]), rng.choice(names)))
    host += host[: n_host // 10]  # repeated ranges
    for h0, h1, _ in list(host[: n_host // 5]):  # ranges nested inside others, sharing a start or an end
        host.append((h0, (h0 + h1) // 2, rng.choice(names)))
        host.append(((h0 + h1) // 2, h1, rng.choice(names)))
    starts = [rng.randrange(span + 10) for _ in range(n_gaps)]
    starts += [h[rng.randrange(2)] for h in host[: n_gaps // 4]]  # gaps starting on a range's edge
    rng.shuffle(starts)
    return [(s, s + rng.randrange(1, 50)) for s in starts], host


@pytest.mark.parametrize("seed", range(20))
def test_one_pass_equals_the_scan(seed):
    rng = random.Random(seed)
    gaps, host = _case(rng, rng.randrange(0, 60), rng.randrange(0, 200), rng.choice([20, 200, 5000]))
    assert harness._gap_owners(gaps, host) == _scan(gaps, host)


def test_nested_and_outside():
    host = [(0, 100, "bench/window"), (10, 20, "bench/issue"), (10, 20, "bench/b"), (15, 30, "bench/wait"),
            (40, 40, "bench/point")]
    gaps = [(5, 6), (12, 13), (15, 16), (20, 21), (25, 26), (31, 32), (40, 41), (101, 102), (-5, -1)]
    want = ["bench/window", "bench/issue", "bench/wait", "bench/wait", "bench/wait", "bench/window", "bench/point",
            harness.OUTSIDE, harness.OUTSIDE]
    assert harness._gap_owners(gaps, host) == _scan(gaps, host) == want


class _Event:
    def __init__(self, name, start, end, device, user):
        self._n, self._s, self._e, self._d, self._u = name, start, end, device, user

    def is_user_annotation(self):
        return self._u

    def device_type(self):
        return self._d

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s


class _Profile:
    def __init__(self, events):
        kineto = type("K", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": kineto})()


def test_profile_summary_breakdown_equals_the_scan():
    """The whole summary on a synthetic profile: busy seconds and every row
    of the breakdown as the scan gives them."""
    import torch

    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    rng = random.Random(7)
    events = [_Event("bench/window", 1_000, 900_000, cpu, True)]
    t = 0
    for layer in range(300):
        events.append(_Event("bench/issue", t, t + 700, cpu, True))
        events.append(_Event("bench/wait", t + 700, t + 2_900, cpu, True))
        s = t + rng.randrange(100, 800)
        for _ in range(rng.randrange(1, 6)):
            e = s + rng.randrange(1, 400)
            events.append(_Event(f"kernel{rng.randrange(4)}", s, e, gpu, False))
            s = e + rng.choice([0, 0, 3, 40])
        t += 3_000
    busy, breakdown = harness._profile_summary(_Profile(events), 0.9)
    rows = sorted((max(e.start_ns(), 1_000), min(e.end_ns(), 900_000)) for e in events
                  if not e.is_user_annotation() and e.end_ns() > 1_000 and e.start_ns() < 900_000)
    gaps, cur = [], rows[0][1]
    for s, e in rows[1:]:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    host = [(e.start_ns(), e.end_ns(), e.name()) for e in events
            if e.is_user_annotation() and e.name() != "bench/window"]
    idle = {}
    for (g0, g1), name in zip(gaps, _scan(gaps, host)):
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e9
    assert breakdown["idle_gaps"] == [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]
    span = max(e for _, e in rows) - rows[0][0]
    assert busy == pytest.approx((span - sum(g1 - g0 for g0, g1 in gaps)) / 1e9, abs=1e-15)
