"""The fold microbenchmark, kernel K4: a bf16 distance GEMM with one of nine
top-2 folds, the counterpart of ``benchmarks/fold_micro.py``'s
``_variant_kernel``.

Every variant takes bf16 operands ``a`` (..., M, 128) and ``b`` (..., N,
128) with fp32 norms ``b_norm`` (..., N) and folds d = ``b_norm - 2 a.b``
(fp32 accumulation; no ``||a||^2``, no clamp) into (min1, idx1 int32,
min2), each (..., M).  Fields a variant does not produce keep their
initial values, ``BIG`` and -1.  ``gemm`` and ``rowsum`` add their sums to
``base``: ``BIG`` in the benchmark, where it hides them, and 0 where a
check reads them.  ``csrc/fold_micro.cu`` says what each
variant computes; ``fold_variant_plain`` computes the same on a
materialised d.  K1 itself on the same operands (the TPU benchmark's
``full``) is ``kernels.match.fused_match_topk_prepared``.

``fold_variant`` takes CPU tensors to the plain version and CUDA tensors to
the kernel; there is no fallback from one to the other.  The kernel splits
each pair's B rows into ``column_splits`` parts, one CTA each, and merges
their partial results in column order; ``fold_variant_plain`` takes the same
decomposition as ``splits``.  No main path of the system runs K4:
``tools/fold_micro.py`` times it.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.match import top2_min
from . import _build

FOLDS = _build.K4_FOLDS
BIG = 3.4e38          # the initial value of min1 and min2
BIAS = 256.0          # slotpack: keys of d + BIAS, which must be > 0
KEY_COLS = 0x7FFF     # slotpack: the low bits of a key hold the column
KEY_NONE = 0x7FFFFFFF     # slotpack: no key
KEY_INF = 0x7F800000      # slotpack: a key at or above holds no value
TILE_N = 64           # gemm sums every TILE_N-th column (K1's tile width)
ROWS = 128            # A rows per CTA of the CUDA kernel
SPLIT_COLS = 128      # B rows per tile of the CUDA kernel; a split holds whole tiles
MAX_SPLITS = 8        # parts of a pair's columns at most

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_I, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P, _P, _P]
_SIGNATURES = {"nm_fold_variant": _ARGS + [_I, _P, _P, _P]}
SCRATCH_WORDS = 1 << 20   # the partials' buffer at least, so it is rarely regrown
SCRATCH_COUNTERS = 4096
_SCRATCH: dict = {}       # device index -> (partials int32, counters int32)
_SMS: dict = {}           # device index -> SM count


def launch_name(fold: str) -> str:
    """The ``_build.K4_LAUNCHES`` key of one variant."""
    return f"k4_fold_{fold}"


def column_splits(pairs: int, m: int, n: int, sms: int) -> int:
    """How many parts the kernel splits each pair's B tiles into: the
    largest power of two up to ``MAX_SPLITS``, and at most one a tile, whose
    CTAs of (row block, part, pair) still fit the card's ``sms`` SMs once."""
    most = min(MAX_SPLITS, -(-n // SPLIT_COLS), max(1, sms // (pairs * -(-m // ROWS))))
    return 1 << (most.bit_length() - 1)


def split_bounds(n: int, splits: int, split_cols: int = SPLIT_COLS):
    """The [start, end) columns of each part: ``splits`` (at most one a
    unit) runs of whole ``split_cols``-wide units, as the kernel's CTAs
    take their tiles."""
    units = -(-n // split_cols)
    splits = max(1, min(splits, units))
    return [(s * units // splits * split_cols,
             min(n, (s + 1) * units // splits * split_cols)) for s in range(splits)]


def distances(a_mat, b_mat, b_norm) -> torch.Tensor:
    """d = ``b_norm - 2 a.b`` in fp32 from the bf16 operands, (..., M, N)."""
    ab = torch.matmul(a_mat.to(torch.float32),
                      b_mat.to(torch.float32).transpose(-1, -2))
    return b_norm[..., None, :] - 2.0 * ab


def _keys(a_mat, b_mat, b_norm) -> torch.Tensor:
    """slotpack's int32 keys ``(bits(d + 256) & ~0x7FFF) | column``, the
    bias added to the norms first, as the kernel adds it."""
    ab = torch.matmul(a_mat.to(torch.float32),
                      b_mat.to(torch.float32).transpose(-1, -2))
    d = (b_norm + BIAS)[..., None, :] - 2.0 * ab
    cols = torch.arange(d.shape[-1], dtype=torch.int32, device=d.device)
    return (d.view(torch.int32) & ~KEY_COLS) | cols


def _decode(key: torch.Tensor) -> torch.Tensor:
    return (key & ~KEY_COLS).view(torch.float32) - BIAS


def _partial(fold, a_mat, b_mat, b_norm, cols, tn):
    """One part's result over columns ``cols`` = (start, end), in the form
    the kernel's merge takes (its ``Part``): a tuple of tensors."""
    c0, c1 = cols
    if fold == "slotpack":
        keys = _keys(a_mat, b_mat[..., c0:c1, :], b_norm[..., c0:c1]) + c0
        keys = torch.cat([keys, torch.full_like(keys[..., :1], KEY_NONE)], dim=-1)
        k = torch.topk(keys.to(torch.int64), 2, dim=-1, largest=False).values
        return k[..., 0].to(torch.int32), k[..., 1].to(torch.int32)
    if fold in ("gemm", "rowsum"):
        ab = torch.matmul(a_mat.to(torch.float32),
                          b_mat[..., c0:c1, :].to(torch.float32).transpose(-1, -2))
        cols = ab[..., (-c0) % tn::tn] if fold == "gemm" else ab
        return ((-2.0 * cols).sum(-1),)
    d = distances(a_mat, b_mat[..., c0:c1, :], b_norm[..., c0:c1])
    if fold == "min1":
        return (d.min(dim=-1).values,)
    if fold == "top2noi":
        v = torch.topk(torch.cat([d, torch.full_like(d[..., :1], BIG)], dim=-1), 2,
                       dim=-1, largest=False).values
        return v[..., 0], v[..., 1]
    if fold == "bf16":
        d = d.to(torch.bfloat16).to(torch.float32)
    elif fold not in ("current", "pipe", "top2idx"):
        raise ValueError(f"unknown fold variant {fold!r}; expected one of {FOLDS}")
    m1, i1, m2 = top2_min(d)
    return m1, i1 + c0, torch.clamp(m2, max=BIG)   # one column: no second value


def _combine(fold, a, b):
    """The kernel's ``combine``: ``a``'s columns all lie before ``b``'s."""
    if fold in ("gemm", "rowsum"):
        return (a[0] + b[0],)
    if fold == "min1":
        return (torch.minimum(a[0], b[0]),)
    if fold in ("top2noi", "slotpack"):
        return (torch.minimum(a[0], b[0]),
                torch.minimum(torch.maximum(a[0], b[0]), torch.minimum(a[1], b[1])))
    (a1, ai, a2), (b1, bi, b2) = a, b      # K1's merge: a tie keeps a's column
    take = (b1 < a1) | ((b1 == a1) & (bi < ai))
    return (torch.where(take, b1, a1), torch.where(take, bi, ai),
            torch.where(take, torch.minimum(a1, b2), torch.minimum(a2, b1)))


def _emit(fold, part, base, lead, device):
    big = torch.full(lead, BIG, dtype=torch.float32, device=device)
    none = torch.full(lead, -1, dtype=torch.int32, device=device)
    if fold in ("gemm", "rowsum"):
        return base + part[0], none, big
    if fold == "min1":
        return part[0], none, big
    if fold == "top2noi":
        return part[0], none, part[1]
    if fold == "slotpack":
        k1, k2 = part
        v2 = torch.where((k2 & ~KEY_COLS) >= KEY_INF, big, _decode(k2))
        return _decode(k1), k1 & KEY_COLS, v2
    return part


def fold_variant_plain(a_mat, b_mat, b_norm, fold: str, tn: int = TILE_N,
                       base: float = BIG, splits: int = 1,
                       split_cols: int = SPLIT_COLS):
    """Plain PyTorch K4 on a materialised d.  ``tn``: ``gemm`` sums every
    ``tn``-th column (the CUDA kernel's is ``TILE_N``); ``base``: what
    ``gemm`` and ``rowsum`` add their sums to, once; ``splits`` and
    ``split_cols``: the kernel's decomposition, the columns cut into that
    many parts of whole ``split_cols``-wide units (``split_bounds``), each
    folded alone and the parts merged in column order with the kernel's
    rules (``fold_variant`` passes ``column_splits``)."""
    if fold not in FOLDS:
        raise ValueError(f"unknown fold variant {fold!r}; expected one of {FOLDS}")
    parts = [_partial(fold, a_mat, b_mat, b_norm, cols, tn)
             for cols in split_bounds(b_mat.shape[-2], splits, split_cols)]
    part = parts[0]
    for nxt in parts[1:]:
        part = _combine(fold, part, nxt)
    return _emit(fold, part, base, a_mat.shape[:-1], a_mat.device)


def fold_variant(a_mat, b_mat, b_norm, fold: str, base: float = BIG):
    """One K4 variant: (..., M, 128) x (..., N, 128) bf16 with (..., N) fp32
    norms -> (min1, idx1 int32, min2), each (..., M).  ``base``: what
    ``gemm`` and ``rowsum`` add their sums to."""
    if fold not in FOLDS:
        raise ValueError(f"unknown fold variant {fold!r}; expected one of {FOLDS}")
    if a_mat.device.type == "cpu":
        return fold_variant_plain(a_mat, b_mat, b_norm, fold, base=base)
    batched = a_mat.dim() == 3
    if not batched:
        a_mat, b_mat, b_norm = a_mat[None], b_mat[None], b_norm[None]
    if a_mat.dim() != 3 or b_mat.dim() != 3:
        raise ValueError("expected (M, D) or (P, M, D) operands")
    pairs, m, d = a_mat.shape
    n = b_mat.shape[1]
    _build.require_cuda("a_mat", a_mat, torch.bfloat16, (pairs, m, d))
    _build.require_cuda("b_mat", b_mat, torch.bfloat16, (pairs, n, d))
    _build.require_cuda("b_norm", b_norm, torch.float32, (pairs, n))
    if d != 128:
        raise ValueError(f"the K4 kernel takes 128-D descriptors, got {d}")
    if n > KEY_COLS + 1:
        raise ValueError(f"the K4 kernel takes at most {KEY_COLS + 1} B rows, got {n}")
    if a_mat.data_ptr() % 16 or b_mat.data_ptr() % 16:
        raise ValueError("the K4 kernel copies 16-byte aligned rows")
    kw = dict(device=a_mat.device)
    min1 = torch.empty((pairs, m), dtype=torch.float32, **kw)
    idx1 = torch.empty((pairs, m), dtype=torch.int32, **kw)
    min2 = torch.empty((pairs, m), dtype=torch.float32, **kw)
    splits, scratch, counters = _split_args(a_mat.device, pairs, m, n)
    lib = _build.load("fold_micro", _SIGNATURES)
    rc = lib.nm_fold_variant(FOLDS.index(fold), a_mat.data_ptr(), b_mat.data_ptr(),
                             b_norm.data_ptr(), pairs, m, n, d, base, min1.data_ptr(),
                             idx1.data_ptr(), min2.data_ptr(), splits, scratch, counters,
                             _build.stream_ptr(a_mat))
    _build.check(rc, f"K4 fold {fold}")
    _build.K4_LAUNCHES[launch_name(fold)] += 1
    if not batched:
        return min1[0], idx1[0], min2[0]
    return min1, idx1, min2


def _split_args(device, pairs: int, m: int, n: int):
    """(splits, scratch pointer, counters pointer) of one launch; the
    pointers are 0 with one split."""
    index = torch.device(device).index or 0
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    splits = column_splits(pairs, m, n, _SMS[index])
    if splits == 1:
        return 1, 0, 0
    partials, counters = _scratch(device, 3 * pairs * splits * m, pairs * -(-m // ROWS))
    return splits, partials.data_ptr(), counters.data_ptr()


def _scratch(device, words: int, counters: int):
    """The device's buffers for the column splits: partials (int32 words)
    and the row blocks' counters (zeros, which every launch leaves zero).
    Made once and grown only outside a graph capture, so a captured launch
    keeps pointing at them; launches on one device must not overlap."""
    index = torch.device(device).index or 0
    have = _SCRATCH.get(index)
    if have is None or have[0].numel() < words or have[1].numel() < counters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("K4's split buffers would grow inside a graph capture: "
                               "call fold_variant once at this shape before capturing")
        words = max(words, SCRATCH_WORDS, 0 if have is None else have[0].numel())
        counters = max(counters, SCRATCH_COUNTERS, 0 if have is None else have[1].numel())
        kw = dict(dtype=torch.int32, device=device)
        have = (torch.empty(words, **kw), torch.zeros(counters, **kw))
        _SCRATCH[index] = have
    return have


def _ulp(x: torch.Tensor, bits: int) -> torch.Tensor:
    """The spacing of values with ``bits`` explicit mantissa bits at |x|."""
    e = torch.floor(torch.log2(torch.clamp(x.abs(), min=1e-30)))
    return torch.exp2(e - bits)


def agreement(fold: str, got, want, d: torch.Tensor, base: float = BIG) -> dict:
    """How a result ``got`` of one variant agrees with ``want`` on the same
    operands, whose fp32 distances (``distances``) are ``d``; ``base`` is
    what ``gemm`` and ``rowsum`` added their sums to.

    Rules: ``gemm``/``rowsum`` at ``base`` = ``BIG``: min1 and min2 equal
    ``BIG`` and idx1 is -1 in both.  This checks the benchmark's output
    only: any sum added to 3.4e38 in fp32 gives 3.4e38, so only a result at
    ``base`` = 0 checks the sums: min1 within 1e-4 relative (the products
    are summed in another order), min2 ``BIG`` and idx1 -1.  ``slotpack``/``bf16``: values within one quantum (slotpack:
    the spacing of 8 mantissa bits at ``d + 256``; bf16: one bf16 ulp of
    d), indices equal except in rows whose fp32 top-2 gap is within one
    quantum.  The others: values within 1e-4 of the row's largest |d|,
    indices equal except in rows whose fp32 top-2 values lie within 1e-5
    relative; a variant with no index or no min2 leaves -1 or ``BIG``.
    Returns ``ok``, ``max_abs_err`` (over the produced values) and
    ``exempt_rows`` (rows whose index may differ)."""
    g1, gi, g2 = (t.to(torch.float32) if t.dtype != torch.int32 else t for t in got)
    w1, wi, w2 = (t.to(torch.float32) if t.dtype != torch.int32 else t for t in want)
    if fold in ("gemm", "rowsum"):
        ok = bool(((g2 == BIG) & (w2 == BIG) & (gi == -1) & (wi == -1)).all())
        err = float((g1 - w1).abs().max())
        if base == BIG:
            ok &= bool(((g1 == BIG) & (w1 == BIG)).all())
        else:
            ok &= bool(((g1 - w1).abs() <= 1e-4 * torch.maximum(g1.abs(), w1.abs())).all())
        return {"ok": ok, "max_abs_err": err, "exempt_rows": 0}
    f1, _, f2 = top2_min(d)
    gap = f2 - f1
    if fold == "slotpack":
        tol1, tol2 = _ulp(w1 + BIAS, 8), _ulp(w2 + BIAS, 8)
        exempt = gap <= _ulp(f1 + BIAS, 8)
    elif fold == "bf16":
        tol1, tol2 = _ulp(w1, 7), _ulp(w2, 7)
        exempt = gap <= _ulp(f1, 7)
    else:
        tol1 = tol2 = 1e-4 * d.abs().amax(dim=-1)
        exempt = gap <= 1e-5 * torch.maximum(f1.abs(), f2.abs())
    has_idx = fold not in ("min1", "top2noi")
    has_min2 = fold != "min1"
    err1 = (g1 - w1).abs()
    ok = bool((err1 <= tol1).all())
    err = float(err1.max())
    if has_min2:
        err2 = (g2 - w2).abs()
        ok &= bool((err2 <= tol2).all())
        err = max(err, float(err2.max()))
    else:
        ok &= bool(((g2 == BIG) & (w2 == BIG)).all())
    if has_idx:
        ok &= bool(((gi == wi) | exempt).all())
    else:
        ok &= bool(((gi == -1) & (wi == -1)).all())
    return {"ok": ok, "max_abs_err": err,
            "exempt_rows": int(exempt.sum()) if has_idx else 0}
