"""A numpy model of the EDT min-plus kernel's arithmetic, held against
minplus_rows_plain bit for bit.

The kernel (pvpuformer_tpu_torch/csrc/edt_minplus.cu) runs only on a card,
where tests/test_torch_cuda.py holds it against the plain version on the
inputs built here. `envelope_rows` repeats its algorithm step for step: the
same band split (ceil(W / 32) columns per lane), the same monotone stack per
band, the same five rounds of bridge walks between neighbouring groups of
bands with the same cross-multiplied hull test, the same compaction, binary
search and forward walk per column. Every intermediate is checked against
the kernel's int32 / int64 ranges, a read of a link the kernel never wrote
fails (the links start as None), and an input outside the kernel's domain
raises where the kernel traps. Comparisons are exact: the values are
integers below 2^24 in f32.

This file imports only numpy, torch and hypothesis, so the card tests can
import its inputs on a machine without JAX."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from pvpuformer_tpu_torch.ops import edt, edt_minplus

LANES = 32
DEAD = -2
DOMAIN = 2 ** 24


def _i32(x):
    assert -2 ** 31 <= x < 2 ** 31, x
    return x


def _below(p, yp, q, yq, r, yr, count):
    """csrc/edt_minplus.cu:below: q strictly below the segment p-r."""
    count["tests"] += 1
    lhs, rhs = _i32(yq - yp) * (r - q), _i32(yr - yq) * (q - p)
    assert max(abs(lhs), abs(rhs)) < 2 ** 63
    return lhs < rhs


def envelope_row(row, count):
    """One row through the kernel's steps 1-5 (a warp's lanes run one after
    another inside each step: they touch disjoint sites between two
    __syncwarp). Returns the f32 row."""
    w = len(row)
    if not np.all((row >= 0) & (row < DOMAIN) & (row == np.trunc(row))):
        raise ValueError("outside the kernel's domain: the kernel traps")
    g = [int(v) for v in row]                       # 1. the row as int32
    prv, nxt, hull, res = [None] * w, [None] * w, [None] * w, [None] * w

    def y(i):
        return _i32(i * i + g[i])

    def value(c, s):
        count["values"] += 1
        return _i32((c - s) * (c - s) + g[s])

    band = (w + LANES - 1) // LANES
    lo = [lane * band for lane in range(LANES)]
    hi = [min(x + band, w) for x in lo]
    head, tail = [-1] * LANES, [-1] * LANES
    for lane in range(LANES):                       # 2. band hulls
        if lo[lane] >= w:
            continue
        top = sec = -1
        ytop = ysec = 0
        for i in range(lo[lane], hi[lane]):
            yi = y(i)
            while sec >= 0 and not _below(sec, ysec, top, ytop, i, yi, count):
                top, ytop = sec, ysec
                sec = prv[top]
                if sec >= 0:
                    ysec = y(sec)
            prv[i] = top
            sec, ysec, top, ytop = top, ytop, i, yi
        s, n = top, -1
        while s >= 0:
            nxt[s] = n
            n, s = s, prv[s]
        head[lane], tail[lane] = lo[lane], hi[lane] - 1
    span = 1
    while span < LANES:                             # 3. merges
        rhead, rtail = ([v[x + span] if x + span < LANES else v[x]
                         for x in range(LANES)] for v in (head, tail))
        for lane in range(0, LANES, 2 * span):
            if rhead[lane] < 0:
                continue
            a, b = tail[lane], rhead[lane]
            ya, yb = y(a), y(b)
            while True:
                ap = prv[a]
                if ap >= 0 and not _below(ap, y(ap), a, ya, b, yb, count):
                    prv[a] = DEAD
                    a, ya = ap, y(ap)
                    continue
                bn = nxt[b]
                if bn >= 0 and not _below(a, ya, b, yb, bn, y(bn), count):
                    prv[b] = DEAD
                    b, yb = bn, y(bn)
                    continue
                break
            nxt[a], prv[b] = b, a
            tail[lane] = rtail[lane]
        head = [head[x & ~(2 * span - 1)] for x in range(LANES)]
        tail = [tail[x & ~(2 * span - 1)] for x in range(LANES)]
        span *= 2
    cnt = []                                        # 4. compaction
    for lane in range(LANES):
        c, s = 0, lo[lane]
        while 0 <= s < hi[lane]:
            c += prv[s] != DEAD
            s = nxt[s]
        cnt.append(c)
    offsets = np.concatenate([[0], np.cumsum(cnt)]).tolist()
    n = offsets[-1]
    for lane in range(LANES):
        k, s = offsets[lane], lo[lane]
        while 0 <= s < hi[lane]:
            if prv[s] != DEAD:
                hull[k] = s
                k += 1
            s = nxt[s]
    for lane in range(LANES):                       # 5. per column
        c0 = lo[lane]
        if c0 >= w:
            continue
        left, right = 0, n - 1
        while left < right:
            m = (left + right) >> 1
            if value(c0, hull[m + 1]) >= value(c0, hull[m]):
                right = m
            else:
                left = m + 1
        for c in range(c0, hi[lane]):
            v = value(c, hull[left])
            while left + 1 < n:
                v1 = value(c, hull[left + 1])
                if v1 > v:
                    break
                left += 1
                v = v1
            res[c] = float(v)
    return np.asarray(res, np.float32)


def envelope_rows(f, count=None):
    """(R, W) f32 -> the kernel's output, modelled row by row."""
    count = {"tests": 0, "values": 0} if count is None else count
    return np.stack([envelope_row(r, count) for r in np.asarray(f)])


# ---------------------------------------------------------------- inputs


def _blobs(seed, h, w, n=6):
    """Random discs, radius 2 to h // 4."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    m = np.zeros((h, w), bool)
    for _ in range(n):
        cy, cx, rad = r.integers(0, h), r.integers(0, w), r.integers(2, max(3, h // 4))
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rad ** 2
    return m


def _spiral(h, w):
    """A square spiral of one-pixel walls and one-pixel gaps: every row
    crosses many walls, so its pass-1 distances alternate."""
    m = np.zeros((h, w), bool)
    t, b, left, right = 0, h - 1, 0, w - 1
    while t <= b and left <= right:
        m[t, left:right + 1] = True
        m[t:b + 1, right] = True
        if t + 2 <= b:
            m[b, left:right + 1] = True
        if left + 2 <= right:
            m[t + 2:b + 1, left] = True
        t, b, left, right = t + 2, b - 2, left + 2, right - 2
    return m


def _pass1(mask):
    """The EDT's pass 1 of the port (squared column distances), as the
    min-plus pass gets it."""
    return edt._pass1(torch.from_numpy(mask)[None], "scan")[0].numpy()


def cases(w, h=64):
    """name -> (rows, W) f32 rows in the kernel's domain: each stresses one
    part of the envelope (pops, long bridge walks, ties, collinear sites,
    the int32 / int64 ranges)."""
    r = np.random.default_rng(w)
    c = np.arange(w)
    one_zero = np.full((4, w), DOMAIN - 1.0)
    one_zero[np.arange(4), r.integers(0, w, 4)] = 0.0
    ends = np.full((2, w), DOMAIN - 1.0)
    ends[0, 0] = ends[1, -1] = 0.0
    out = {
        "random": r.integers(0, 90000, (h // 4, w)),
        "squares": np.square(r.integers(0, 300, (h // 4, w))),
        "sparse zeros": np.where(r.uniform(size=(h // 4, w)) < 0.05, 0,
                                 np.square(r.integers(0, 300, (h // 4, w)))),
        "blobs": _pass1(_blobs(w, h, w)),
        "spiral": _pass1(_spiral(h, w)),
        "full": _pass1(np.ones((h, w), bool)),
        "empty": _pass1(np.zeros((4, w), bool)),
        "one zero": one_zero,
        "zero at an end": ends,
        "all equal": np.full((2, w), 7.0),
        # Y = c'^2 + f linear in c': every site collinear
        "collinear": (c * (w - 1 - c))[None],
        # equal candidates midway between zeros: ties at every other column
        "ties": np.where(c % 4 == 0, 0, 2 + c % 2)[None],
        # a decreasing ramp: every band hull is removed by the next band
        "ramp": np.stack([(w - c) * 40.0, np.minimum((w - c) ** 2, DOMAIN - 1)]),
        "domain edge": np.full((1, w), DOMAIN - 1.0),
    }
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def adversarial(rows, w):
    """(rows, W): every case at width W, cycled to `rows` rows."""
    f = np.concatenate(list(cases(w).values()))
    return np.resize(f, (rows, w)).astype(np.float32)


def _plain(f):
    return edt_minplus.minplus_rows_plain(torch.from_numpy(f)).numpy()


def _check(f):
    count = {"tests": 0, "values": 0}
    got = envelope_rows(f, count)
    want = _plain(f)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    return count


# ----------------------------------------------------------------- tests


@pytest.mark.parametrize("w", [1, 2, 31, 32, 33, 448])
def test_model_matches_plain_bit_for_bit(w):
    rows = [v if w < 448 else v[::8] for v in cases(w).values()]
    _check(np.concatenate(rows))


@pytest.mark.parametrize("name", ["one zero", "zero at an end", "domain edge",
                                  "ramp", "collinear"])
def test_model_at_the_widest_row(name):
    """W = 8192, MAX_W: the int32 values reach 8191^2 + 2^24 - 1."""
    f = cases(8192)[name][:2]
    _check(f)


def test_model_work_is_linear_in_w():
    """Per row at most 3 W + 62 hull tests (a site pushed and removed once,
    each of the 31 bridge walks ends on two passing tests) and 4 W +
    64 (ceil(log2 W) + 1) candidate values (per lane one binary search of
    two values a step, then per column one value and one more per check
    of the next vertex, a check failing once per column or advancing)."""
    for w in (33, 448, 8192):
        f = adversarial(64 if w < 8192 else 4, w)
        count = _check(f)
        rows = f.shape[0]
        assert count["tests"] <= rows * (3 * w + 62), (w, count)
        log = int(np.ceil(np.log2(w)))
        assert count["values"] <= rows * (4 * w + 64 * (log + 1)), (w, count)


@given(st.integers(1, 100).flatmap(lambda w: st.lists(
    st.one_of(st.integers(0, DOMAIN - 1), st.integers(0, 4095).map(
        lambda v: v * v), st.just(0), st.just(DOMAIN - 1)),
    min_size=w, max_size=w)))
@settings(max_examples=150, deadline=None, derandomize=True)
def test_model_matches_plain_on_drawn_rows(row):
    _check(np.asarray([row], np.float32))


@pytest.mark.parametrize("bad", [-1.0, 0.5, float(DOMAIN), np.nan, np.inf])
def test_model_rejects_values_outside_the_domain(bad):
    f = np.zeros((1, 40), np.float32)
    f[0, 17] = bad
    with pytest.raises(ValueError, match="domain"):
        envelope_rows(f)
