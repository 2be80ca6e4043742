"""The reference's entropy models, written from the bitstream format and
tensorflow_compression's definitions (a frozen copy of the format's
specification, not of the program's code):

* the factorized hyperprior of z: Balle et al.'s non-parametric density,
  its CDF ``sigmoid(f_K o ... o f_1(x))``, convolved with U(-1/2, 1/2);
* the grid placement the format fixes: the quantization offset and the
  tails at ``tail_mass = 2^-8``, found in float32 by an expanding bracket
  and 60 bisections, and the PMF on the integer grid in float64;
* the PMF's quantization to 12-bit CDF rows (every symbol at least 1, the
  surplus or deficit settled greedily by expected bits, lowest index on a
  tie) with the escape symbol last;
* the range decoder of the host format (``range_coder.h``'s byte-wise
  carry-less coder, escapes as Elias-gamma bits), to read the z strings
  back;
* the Gaussian of y, convolved with U(-1/2, 1/2), at a scale read off the
  64-level log table between 0.11 and 256, for the training loss and the
  ideal rate.
"""

from __future__ import annotations

import bisect
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.layers import LowerBound, UpperBound

TAIL_MASS = 2.0 ** -8
PRECISION = 12
SCALES_MIN, SCALES_MAX, SCALES_LEVELS = 0.11, 256.0, 64


# -- the factorized hyperprior -----------------------------------------------

# The factorized prior's hidden filters (tensorflow_compression's default).
PRIOR_FILTERS = (3, 3, 3)


def prior_shapes(channels, prefix="hyperprior"):
    """Every parameter of a factorized prior over ``channels`` channels and
    its shape, as weights drawn from the seed take them."""
    filters = (1,) + PRIOR_FILTERS + (1,)
    shapes = {}
    for i in range(len(filters) - 1):
        shapes[f"{prefix}/matrices/{i}"] = (channels, filters[i + 1], filters[i])
        shapes[f"{prefix}/biases/{i}"] = (channels, filters[i + 1], 1)
        if i < len(PRIOR_FILTERS):
            shapes[f"{prefix}/factors/{i}"] = (channels, filters[i + 1], 1)
    return shapes


def prior_params(p, prefix="hyperprior"):
    """(matrices, biases, factors) of the factorized prior in ``p``."""
    def field(name):
        out, i = [], 0
        while f"{prefix}/{name}/{i}" in p:
            out.append(p[f"{prefix}/{name}/{i}"])
            i += 1
        return out
    return field("matrices"), field("biases"), field("factors")


def logits_cumulative(prior, x):
    """Logit of the CDF at x (broadcast over the prior's channel axis, the
    trailing one of x). The parameters' softplus and tanh are taken in their
    own dtype and promoted, as the format's float64 table build does."""
    matrices, biases, factors = prior
    dtype = torch.promote_types(x.dtype, matrices[0].dtype)
    u = x.to(dtype)[..., None, None]
    for i, m in enumerate(matrices):
        u = torch.matmul(F.softplus(m).to(dtype), u) + biases[i].to(dtype)
        if i < len(factors):
            u = u + torch.tanh(factors[i]).to(dtype) * torch.tanh(u)
    return u[..., 0, 0]


def _log_diff_exp(big, small):
    return big + torch.log(-torch.expm1(torch.clamp(small - big, max=-1e-12)))


def noisy_log_prob(log_cdf_sf, y):
    """log density of ``X + U(-1/2, 1/2)`` from X's (log CDF, log survival):
    the difference of CDFs left of the median, of survival functions right
    of it."""
    cp, sp = log_cdf_sf(y + 0.5)
    cm, sm = log_cdf_sf(y - 0.5)
    return torch.where(cp + cm < sp + sm, _log_diff_exp(cp, cm), _log_diff_exp(sm, sp))


def prior_log_cdf_sf(prior):
    def fn(x):
        logits = logits_cumulative(prior, x)
        return F.logsigmoid(logits), F.logsigmoid(-logits)
    return fn


def solve_monotone(func, target, shape):
    """``func(x) == target`` elementwise for monotone ``func``, in float32:
    an expanding bracket from [-1, 1] (64 doublings at most), then 60
    bisections; the midpoint of the last bracket."""
    target = torch.broadcast_to(torch.as_tensor(target, dtype=torch.float32), shape)
    probe = torch.zeros(shape, dtype=torch.float32)
    increasing = func(probe + 1.0) >= func(probe - 1.0)

    def enclosed(f_lo, f_hi):
        lo_ok = torch.where(increasing, f_lo <= target, f_lo >= target)
        hi_ok = torch.where(increasing, f_hi >= target, f_hi <= target)
        return lo_ok & hi_ok

    lo = torch.full(shape, -1.0)
    hi = torch.full(shape, 1.0)
    f_lo, f_hi = func(lo), func(hi)
    for _ in range(64):
        ok = enclosed(f_lo, f_hi)
        if bool(ok.all()):
            break
        width = torch.clamp(hi - lo, min=1.0)
        lo = torch.where(ok, lo, lo - width)
        hi = torch.where(ok, hi, hi + width)
        f_lo, f_hi = func(lo), func(hi)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        f_mid = func(mid)
        right = torch.where(increasing, f_mid < target, f_mid > target)
        lo = torch.where(right, mid, lo)
        hi = torch.where(right, hi, mid)
    return 0.5 * (lo + hi)


def _llround(x: float) -> int:
    """Round half away from zero (x >= 0); ``x - floor(x)`` is exact."""
    f = math.floor(x)
    return f + 1 if x - f >= 0.5 else f


def quantize_pmf(pmf, precision=PRECISION):
    """One PMF row (float64, escape last) -> its integer CDF, total
    ``2^precision``: each symbol at least 1, then one step at a time the
    symbol that gains (or loses) least in expected bits, the lowest index
    on a tie."""
    total_target = 1 << precision
    prob = np.array([v if v > 0 and math.isfinite(v) else 0.0 for v in pmf])
    s = 0.0
    for v in prob:
        s += v  # in order, as the format's quantizer sums
    if s <= 0:
        prob, s = np.ones(len(prob)), float(len(prob))
    q = np.array([max(1, _llround(v / s * total_target)) for v in prob], np.int64)
    total = int(q.sum())
    while total != total_target:
        if total < total_target:
            best = int(np.argmax(prob * np.log((q + 1.0) / q)))
            q[best] += 1
            total += 1
        else:
            loss = np.where(q > 1, prob * np.log(q / np.maximum(q - 1.0, 1.0)), np.inf)
            best = int(np.argmin(loss))
            q[best] -= 1
            total -= 1
    return np.concatenate([[0], np.cumsum(q)]).astype(np.int64)


class FactorizedTables:
    """The z tables of a factorized prior (parameters on any device; the
    build runs on the host CPU): per channel its float32 offset, CDF row,
    the value of its first symbol and its length with the escape."""

    def __init__(self, prior):
        prior = tuple([t.detach().cpu() for t in f] for f in prior)
        channels = prior[0][0].shape[0]
        tail = math.log(TAIL_MASS / 2.0) - math.log1p(-TAIL_MASS / 2.0)
        with torch.no_grad():
            targets = torch.tensor([0.0, tail, -tail]).reshape(3, 1)
            pts = solve_monotone(lambda x: logits_cumulative(prior, x), targets,
                                 (3, channels)).double().numpy()
            offset = pts[0] - np.round(pts[0])
            minima = np.floor(pts[1] - offset).astype(np.int64)
            maxima = np.ceil(pts[2] - offset).astype(np.int64)
            lengths = maxima - minima + 1
            width = int(lengths.max())
            grid = minima[:, None] + np.arange(width)[None, :] + offset[:, None]
            x = torch.from_numpy(grid.T.copy())  # (width, channels)
            pmf = torch.exp(noisy_log_prob(prior_log_cdf_sf(prior), x)).double().numpy().T
        valid = np.arange(width)[None, :] < lengths[:, None]
        pmf = np.clip(np.where(valid, pmf, 0.0), 0.0, None)
        escape = np.clip(1.0 - pmf.sum(axis=1), 2.0 ** -20, 1.0)
        self.offset = offset.astype(np.float32)
        self.cdf_offset = minima
        self.rows = [quantize_pmf(list(pmf[c, : lengths[c]]) + [escape[c]]).tolist()
                     for c in range(channels)]


# -- the range decoder of the host format ------------------------------------


class RangeDecoder:
    """Byte-wise range decoder: 32-bit range, 5-byte priming read; reads
    past the end give zeros."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0
        self.range, self.code = 0xFFFFFFFF, 0
        for _ in range(5):
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF

    def _byte(self):
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def decode(self, cdf, precision):
        """The symbol of the next interval in ``cdf``."""
        r = self.range >> precision
        f = min(self.code // r, (1 << precision) - 1)
        s = bisect.bisect_right(cdf, f) - 1
        if s < 0 or s >= len(cdf) - 1:
            raise ValueError("corrupt range-coded stream")
        self.code -= r * cdf[s]
        self.range = r * (cdf[s + 1] - cdf[s])
        while self.range < (1 << 24):
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF
            self.range = (self.range << 8) & 0xFFFFFFFF
        return s

    def bit(self):
        return self.decode([0, 1, 2], 1)


def decode_values(data: bytes, rows, cdf_offsets, index) -> np.ndarray:
    """The values of one stream, element k coded with row ``index[k]``; an
    escape is followed by the Elias-gamma code of its zigzagged excess."""
    dec = RangeDecoder(data)
    out = np.empty(len(index), np.int64)
    for k, r in enumerate(index):
        cdf = rows[r]
        escape = len(cdf) - 2
        s = dec.decode(cdf, PRECISION)
        if s == escape:
            n = 0
            while dec.bit() == 0:
                n += 1
                if n > 62:
                    raise ValueError("corrupt escape in range-coded stream")
            g = 1
            for _ in range(n):
                g = (g << 1) | dec.bit()
            e = g - 1
            s = escape + e // 2 if e % 2 == 0 else -((e + 1) // 2)
        out[k] = s + cdf_offsets[r]
    return out


# -- the scale-indexed Gaussian of y --------------------------------------------

_LOG_STEP = (math.log(SCALES_MAX) - math.log(SCALES_MIN)) / (SCALES_LEVELS - 1)


def scale_index(sigma):
    """Continuous index of sigma on the log table, clipped to [0, 63] with
    the bound ops' gradients."""
    idx = (torch.log(sigma) - math.log(SCALES_MIN)) / _LOG_STEP
    return UpperBound.apply(LowerBound.apply(idx, 0.0), SCALES_LEVELS - 1.0)


def table_scale(index):
    return torch.exp(math.log(SCALES_MIN) + _LOG_STEP * index)


def gaussian_log_cdf_sf(scale):
    def fn(x):
        z = x / scale
        return torch.special.log_ndtr(z), torch.special.log_ndtr(-z)
    return fn


def y_bits(y_tilde, sigma, ndim=3):
    """Bits of each image's noisy (or rounded, centred) y under the
    Gaussian at sigma's table scale."""
    scale = table_scale(scale_index(sigma))
    log_p = noisy_log_prob(gaussian_log_cdf_sf(scale), y_tilde) / math.log(2.0)
    return -torch.sum(log_p, dim=tuple(range(y_tilde.ndim - ndim, y_tilde.ndim)))


def z_bits(prior, z_tilde, ndim=3):
    log_p = noisy_log_prob(prior_log_cdf_sf(prior), z_tilde) / math.log(2.0)
    return -torch.sum(log_p, dim=tuple(range(z_tilde.ndim - ndim, z_tilde.ndim)))


class GaussianTables:
    """The y tables of the scale-indexed Gaussian: one row a level of the
    64-level log table, the Gaussian at that scale convolved with
    U(-1/2, 1/2) on the integers between its tails at ``tail_mass / 2``
    (the scale in float32, the tails and the PMF in float64), quantized as
    the z rows are, the escape symbol last. ``bits[r, m]`` is the cost in
    bits of index m (the escape last) in row r."""

    def __init__(self):
        scales = table_scale(torch.arange(SCALES_LEVELS, dtype=torch.float32))
        edge = float(torch.special.ndtri(torch.tensor(TAIL_MASS / 2.0, dtype=torch.float64)))
        s64 = scales.double().numpy()
        minima = np.floor(s64 * edge).astype(np.int64)
        maxima = np.ceil(-s64 * edge).astype(np.int64)
        lengths = maxima - minima + 1
        width = int(lengths.max())
        grid = torch.from_numpy((minima[:, None] + np.arange(width)[None, :]).astype(np.float64))
        pmf = torch.exp(noisy_log_prob(gaussian_log_cdf_sf(scales[:, None]), grid)).numpy()
        valid = np.arange(width)[None, :] < lengths[:, None]
        pmf = np.clip(np.where(valid, pmf, 0.0), 0.0, None)
        escape = np.clip(1.0 - pmf.sum(axis=1), 2.0 ** -20, 1.0)
        self.cdf_offset = minima
        self.lengths = lengths  # symbols before the escape
        self.rows = [quantize_pmf(list(pmf[r, : lengths[r]]) + [escape[r]]).tolist()
                     for r in range(SCALES_LEVELS)]
        bits = np.zeros((SCALES_LEVELS, width + 1))
        for r, row in enumerate(self.rows):
            freq = np.diff(np.asarray(row, np.float64))
            bits[r, : len(freq)] = PRECISION - np.log2(freq)
        self.bits = bits


def scale_rows(sigma):
    """The rows a coder picks for sigma: its index on the log table,
    clipped and rounded."""
    return torch.round(scale_index(sigma)).to(torch.int64)


def y_coded_bits(tables: GaussianTables, symbols, rows, escape_bits) -> torch.Tensor:
    """Bits of each image's y symbols (centred; int, (n, ...)) coded against
    ``rows`` with ``tables``: each in-table symbol its row's cost, each
    symbol outside the table the escape's cost plus ``escape_bits(excess)``,
    the format's payload for an escape of that zigzagged excess."""
    dev = symbols.device
    offset = torch.as_tensor(tables.cdf_offset, device=dev)[rows]
    length = torch.as_tensor(tables.lengths, device=dev)[rows]
    m = symbols.to(torch.int64) - offset
    inside = (m >= 0) & (m < length)
    index = torch.where(inside, m, length)
    cost = torch.as_tensor(tables.bits, device=dev)[rows, index]
    excess = torch.where(m >= length, 2 * (m - length), -2 * m - 1)
    cost = cost + torch.where(inside, torch.zeros_like(cost), escape_bits(excess).double())
    return cost.reshape(cost.shape[0], -1).sum(dim=1)


def range_escape_bits(excess):
    """The host format's escape payload: the Elias-gamma code of
    ``excess + 1``, one bit a binary decision."""
    g = (excess + 1).clamp_min(1).double()
    return 2.0 * torch.floor(torch.log2(g)) + 1.0


def rans_escape_bits(excess):
    """The device format's escape payload: two raw 16-bit words."""
    return torch.full_like(excess, 32, dtype=torch.float64)
