"""Wrappers around the CUDA kernels: checks, output allocation, launch.

A wrapper given CPU tensors runs the kernel's plain twin (``ref.py``);
given CUDA tensors it launches the kernel on the current stream, or
raises.  It never falls back from one to the other.  ``launches`` counts
kernel launches per wrapper, so a run can show which kernels its path
went through; ``mode_launches`` splits the fused kernels' launches by
distance mode, so a quantized launch (kernel B3) is told from a float32
one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import (
    QUANT_MODES,
    candidate_dist_ref,
    candidate_verify_ref,
    fused_cand_search_ref,
    fused_window_search_ref,
    merge_schedule_ref,
    pairwise_l2_ref,
    select_blocks_ref,
    window_dist_ref,
    window_verify_ref,
)
# the reference's ops._quantize_query: the kernels and their twins share it
from .ref import quantize_query as _quantize_query

__all__ = [
    "fused_window_search",
    "fused_cand_search",
    "window_verify",
    "candidate_verify",
    "window_dist",
    "candidate_dist",
    "pairwise_l2",
    "select_blocks",
    "merge_schedule",
    "launches",
    "mode_launches",
    "reset_launches",
]

#: distance modes of the fused kernels, in the kernels' numbering: the
#: float32 norm and diff forms, and the quantized dots of kernel B3
_MODES = ("norm", "exact", *QUANT_MODES)
_X_DTYPES = {"norm": torch.float32, "exact": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}

#: kernel launches per wrapper since the last ``reset_launches()``
launches = {"fused_window_search": 0, "fused_cand_search": 0, "window_verify": 0,
            "candidate_verify": 0, "window_dist": 0, "candidate_dist": 0, "pairwise_l2": 0,
            "select_blocks": 0, "merge_schedule": 0}
#: the fused kernels' launches per distance mode (their sum is ``launches``)
mode_launches = {name: dict.fromkeys(_MODES, 0)
                 for name in ("fused_window_search", "fused_cand_search")}

_MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
_MAX_GRID_Y = 65_535  # a launch grid's largest y extent


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    for counts in mode_launches.values():
        for mode in counts:
            counts[mode] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind == "cuda"


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:  # torch.Size is a tuple
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_mode(mode: str, x: torch.Tensor, scale, scale_name: str) -> None:
    """The mode exists, x has its dtype, and a dequant scale (float32) is
    given exactly when the mode is quantized."""
    if mode not in _MODES:
        raise ValueError(f"unknown distance mode {mode!r}: use " + " | ".join(_MODES))
    if x.dtype != _X_DTYPES[mode]:
        raise TypeError(f"mode {mode!r} takes {_X_DTYPES[mode]} vectors, got {x.dtype}")
    if (scale is not None) != (mode in QUANT_MODES):
        raise ValueError(f"{scale_name} is required by the quantized modes "
                         f"{QUANT_MODES} and only by them (mode {mode!r})")
    if scale is not None and scale.dtype != torch.float32:
        raise TypeError(f"{scale_name}: dtype {scale.dtype}, expected torch.float32")


def _query_operands(q: torch.Tensor, mode: str):
    """(qv, q2, qs) as the kernels read them: the query in the mode's
    dtype, the float32 query's squared norms (Q,), the query scales (Q,)
    or None."""
    q2 = torch.sum(torch.square(q), dim=-1)
    qv, qs = _quantize_query(q, mode)
    return qv.contiguous(), q2, None if qs is None else qs.reshape(-1).contiguous()


def _prepare(lib, mode: str, steps: int, L: int, K: int, d: int, C: int, S: int,
             ks: int, n: int):
    """Shape guards shared by both fused kernels (S: B1's selected blocks
    per query, 0 for B2): the query's whole pool must fit one block's
    shared memory."""
    smem = lib.fused_search_smem_bytes(_MODES.index(mode), steps, L, K, d, C, S)
    _check_smem(smem, C)
    _check_k(ks, n)


def _check_smem(smem: int, C: int) -> None:
    if smem > _MAX_SMEM:
        raise ValueError(
            f"{C} candidate slots per query need {smem} bytes of shared "
            f"memory; the kernel takes at most {_MAX_SMEM}"
        )


def _check_k(ks: int, n: int) -> None:
    if ks < 1 or not 0 <= n < 2**31 - 1:
        raise ValueError(f"unsupported ks={ks} or n={n}")


def _outputs(Qn: int, steps: int, ks: int, device):
    return (
        torch.empty((Qn, steps, ks), dtype=torch.float32, device=device),
        torch.empty((Qn, steps, ks), dtype=torch.int32, device=device),
        torch.empty((Qn, steps), dtype=torch.int32, device=device),
    )


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.fused_search_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _count(name: str, mode: str) -> None:
    launches[name] += 1
    mode_launches[name][mode] += 1


def fused_window_search(blk_idx, halves, proj_blocks, x_blocks, norm_blocks,
                        ids_blocks, g, q, *, M: int, ks: int, n: int,
                        mode: str = "norm", x_scale=None):
    """Fused one-pass search over the selected STR blocks (kernel B1; in
    the modes bf16/int8, kernel B3).

    Args:
      blk_idx: (Q, S) int32 flattened block ids, S = L*M (ids outside
        [0, L*nb) are invalid slots and contribute nothing).
      halves: (steps,) f32 schedule half window widths, ascending.
      proj_blocks: (L*nb, B, K) f32; x_blocks: (L*nb, B, d) f32 (modes
        'norm'/'exact') or the quantized blocks (bf16 / int8 for modes
        'bf16' / 'int8'); norm_blocks: (L*nb, B) f32 (+inf padded);
      ids_blocks: (L*nb, B) int32; g: (Q, L, K) f32; q: (Q, d) f32 (the
        quantized modes quantize it as the reference does).
      M: blocks per table (slot s belongs to table s // M); ks: bin width
        (k, or 4k for the quantized shortlist); n: the id of unfilled
        slots; mode: 'norm' | 'exact' | 'bf16' | 'int8'.
      x_scale: (L*nb, B) f32 per-slot dequant scales (quantized modes only).

    Returns: bins_d (Q, steps, ks) f32 ascending, bins_i (Q, steps, ks)
    int32 (``n`` unfilled), cnt (Q, steps) int32 slots per bin.
    """
    _check_mode(mode, x_blocks, x_scale, "x_scale")
    args = (blk_idx, halves, proj_blocks, x_blocks, norm_blocks, ids_blocks, g, q)
    if not _on_cuda(*args, *(() if x_scale is None else (x_scale,))):
        return fused_window_search_ref(*args, M=M, ks=ks, n=n, mode=mode, x_scale=x_scale)

    Qn, S = blk_idx.shape
    lnb, B, K = proj_blocks.shape
    d = x_blocks.shape[-1]
    L = g.shape[1]
    steps = halves.shape[0]
    if S != L * M:
        raise ValueError(f"S={S} slots but L*M={L * M}")
    f32, i32 = torch.float32, torch.int32
    _check("blk_idx", blk_idx, i32, (Qn, S))
    _check("halves", halves, f32, (steps,))
    _check("proj_blocks", proj_blocks, f32, (lnb, B, K))
    _check("x_blocks", x_blocks, x_blocks.dtype, (lnb, B, d))
    _check("norm_blocks", norm_blocks, f32, (lnb, B))
    _check("ids_blocks", ids_blocks, i32, (lnb, B))
    _check("g", g, f32, (Qn, L, K))
    _check("q", q, f32, (Qn, d))
    if x_scale is not None:
        _check("x_scale", x_scale, f32, (lnb, B))
    lib = _build.load()
    _prepare(lib, mode, steps, L, K, d, S * B, S, ks, n)
    bd, bi, cnt = _outputs(Qn, steps, ks, q.device)
    if Qn == 0:
        return bd, bi, cnt
    qv, q2, qs = _query_operands(q, mode)
    with torch.cuda.device(q.device):
        err = lib.fused_window_search_launch(
            *map(_ptr, (blk_idx, halves, proj_blocks, x_blocks, norm_blocks,
                        ids_blocks, g, qv, q2, qs, x_scale, bd, bi, cnt)),
            Qn, S, M, lnb, B, K, d, L, steps, ks, n, _MODES.index(mode),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _raise_on(lib, err, "fused_window_search")
    _count("fused_window_search", mode)
    return bd, bi, cnt


def fused_cand_search(cand_proj, cand_x, cand_norms, cand_ids, halves, g, q, *,
                      ks: int, n: int, mode: str = "norm", cand_scale=None):
    """Fused one-pass search over pre-gathered candidates (kernel B2; in
    the modes bf16/int8, kernel B3).

    Args:
      cand_proj: (Q, L, Ct, K) f32 (+inf on invalid slots — that alone
        keeps them out of every bin); cand_x: (Q, L, Ct, d) f32, or bf16 /
        int8 in the quantized modes; cand_norms: (Q, L, Ct) f32 (+inf
        padded); cand_ids: (Q, L, Ct) int32; halves: (steps,); g: (Q, L, K);
        q: (Q, d) f32; cand_scale: (Q, L, Ct) f32 dequant scales
        (quantized modes only).

    Returns: (bins_d, bins_i, cnt) as :func:`fused_window_search`.
    """
    _check_mode(mode, cand_x, cand_scale, "cand_scale")
    args = (cand_proj, cand_x, cand_norms, cand_ids, halves, g, q)
    if not _on_cuda(*args, *(() if cand_scale is None else (cand_scale,))):
        return fused_cand_search_ref(*args, ks=ks, n=n, mode=mode, cand_scale=cand_scale)

    Qn, L, Ct, K = cand_proj.shape
    d = cand_x.shape[-1]
    steps = halves.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check("cand_proj", cand_proj, f32, (Qn, L, Ct, K))
    _check("cand_x", cand_x, cand_x.dtype, (Qn, L, Ct, d))
    _check("cand_norms", cand_norms, f32, (Qn, L, Ct))
    _check("cand_ids", cand_ids, i32, (Qn, L, Ct))
    _check("halves", halves, f32, (steps,))
    _check("g", g, f32, (Qn, L, K))
    _check("q", q, f32, (Qn, d))
    if cand_scale is not None:
        _check("cand_scale", cand_scale, f32, (Qn, L, Ct))
    lib = _build.load()
    _prepare(lib, mode, steps, L, K, d, L * Ct, 0, ks, n)
    bd, bi, cnt = _outputs(Qn, steps, ks, q.device)
    if Qn == 0:
        return bd, bi, cnt
    qv, q2, qs = _query_operands(q, mode)
    with torch.cuda.device(q.device):
        err = lib.fused_cand_search_launch(
            *map(_ptr, (cand_proj, cand_x, cand_norms, cand_ids, halves, g, qv,
                        q2, qs, cand_scale, bd, bi, cnt)),
            Qn, L, Ct, K, d, steps, ks, n, _MODES.index(mode),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _raise_on(lib, err, "fused_cand_search")
    _count("fused_cand_search", mode)
    return bd, bi, cnt


@functools.lru_cache(maxsize=256)
def _verify_smem(K: int, d: int, C: int, M: int, k: int) -> int:
    """Shared memory one block of a verify kernel asks for (M: B6's blocks
    per query, 0 for B7): a function of the shape alone, asked once."""
    return _build.load().verify_smem_bytes(K, d, C, M, k)


def _verify_launch(name: str, q: torch.Tensor, K: int, C: int, M: int, k: int, n: int,
                   launch):
    """Shared tail of the per-radius verify wrappers: guards, outputs,
    the launch on the current stream (operands passed as plain addresses),
    the count."""
    _check_smem(_verify_smem(K, q.shape[-1], C, M, k), C)
    _check_k(k, n)
    Qn = q.shape[0]
    bd = torch.empty((Qn, k), dtype=torch.float32, device=q.device)
    bi = torch.empty((Qn, k), dtype=torch.int32, device=q.device)
    if Qn == 0:
        return bd, bi
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = launch(lib, bd.data_ptr(), bi.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, name)
    launches[name] += 1
    return bd, bi


def window_verify(blk_idx, proj_blocks, vec_blocks, ids_blocks, g, q, w: float, *,
                  n: int, k: int):
    """Window verify of one table at one width, over its selected STR
    blocks read in place (kernel B6, the multi-pass ``inline`` engine).

    Args:
      blk_idx: (Q, M) int32 block ids (ids outside [0, nb) are invalid
        slots and contribute nothing).
      proj_blocks: (nb, B, K) f32 (+inf padded); vec_blocks: (nb, B, d) f32;
      ids_blocks: (nb, B) int32 (``n`` padded).
      g: (Q, K) f32 query projections in this table; q: (Q, d) f32.
      w: window width; a slot is in the window when max_k |p_k - g_k| <=
        0.5 * w (in float32).
      n: the id of unfilled entries (ids >= n never count); k: top-k.

    Returns: (Q, k) squared distances ascending (+inf unfilled), (Q, k)
    int32 ids (``n`` unfilled): the k lexicographically smallest distinct
    (d2, id) pairs of the in-window slots.
    """
    args = (blk_idx, proj_blocks, vec_blocks, ids_blocks, g, q)
    if not _on_cuda(*args):
        return window_verify_ref(*args, w, n=n, k=k)

    Qn, M = blk_idx.shape
    nb, B, K = proj_blocks.shape
    d = vec_blocks.shape[-1]
    f32, i32 = torch.float32, torch.int32
    _check("blk_idx", blk_idx, i32, (Qn, M))
    _check("proj_blocks", proj_blocks, f32, (nb, B, K))
    _check("vec_blocks", vec_blocks, f32, (nb, B, d))
    _check("ids_blocks", ids_blocks, i32, (nb, B))
    _check("g", g, f32, (Qn, K))
    _check("q", q, f32, (Qn, d))
    return _verify_launch(
        "window_verify", q, K, M * B, M, k, n,
        lambda lib, bd, bi, stream: lib.window_verify_launch(
            *(t.data_ptr() for t in args), float(w), bd, bi, Qn, M, nb, B, K, d, k, n,
            stream),
    )


def candidate_verify(cand_proj, cand_vecs, cand_ids, g, q, w: float, *, n: int, k: int):
    """Window verify of pre-gathered candidates at one width (kernel B7,
    the multi-pass ``kernel`` engine).

    Args:
      cand_proj: (Q, C, K) f32 (+inf on invalid slots: that alone keeps
        them out of the window); cand_vecs: (Q, C, d) f32;
      cand_ids: (Q, C) int32; g: (Q, K); q: (Q, d); w, n, k as
        :func:`window_verify`.

    Returns: (Q, k) squared distances and int32 ids, as :func:`window_verify`.
    """
    args = (cand_proj, cand_vecs, cand_ids, g, q)
    if not _on_cuda(*args):
        return candidate_verify_ref(*args, w, n=n, k=k)

    Qn, C, K = cand_proj.shape
    d = cand_vecs.shape[-1]
    f32, i32 = torch.float32, torch.int32
    _check("cand_proj", cand_proj, f32, (Qn, C, K))
    _check("cand_vecs", cand_vecs, f32, (Qn, C, d))
    _check("cand_ids", cand_ids, i32, (Qn, C))
    _check("g", g, f32, (Qn, K))
    _check("q", q, f32, (Qn, d))
    return _verify_launch(
        "candidate_verify", q, K, C, 0, k, n,
        lambda lib, bd, bi, stream: lib.candidate_verify_launch(
            *(t.data_ptr() for t in args), float(w), bd, bi, Qn, C, K, d, k, n, stream),
    )


@functools.lru_cache(maxsize=256)
def _dist_smem(K: int, d: int) -> int:
    """Shared memory one block of a distance kernel asks for: one unit's
    stage (64 rows, fewer where 64 would not fit) and its row table, a
    function of the shape alone, asked once."""
    return _build.load().dist_smem_bytes(K, d)


def _dist_launch(name: str, q: torch.Tensor, K: int, C: int, launch):
    """Shared tail of the per-slot distance wrappers: the shared memory
    guard, the (Q, C) outputs d2 and hw, q2 as the fused kernels' wrappers
    compute it, the launch on the current stream, the count."""
    smem = _dist_smem(K, q.shape[-1])
    if smem > _MAX_SMEM:
        raise ValueError(f"{name}: the stage of one row (K={K}, d={q.shape[-1]}) needs "
                         f"{smem} bytes of shared memory, above {_MAX_SMEM}")
    lib = _build.load()
    Qn = q.shape[0]
    d2 = torch.empty((Qn, C), dtype=torch.float32, device=q.device)
    hw = torch.empty((Qn, C), dtype=torch.float32, device=q.device)
    if Qn == 0 or C == 0:
        return d2, hw
    q2 = torch.sum(torch.square(q), dim=-1)
    with torch.cuda.device(q.device):
        err = launch(lib, _ptr(q2), _ptr(d2), _ptr(hw),
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _raise_on(lib, err, name)
    launches[name] += 1
    return d2, hw


def window_dist(blk_idx, proj_blocks, vec_blocks, norm_blocks, g, q, *, M: int,
                exact: bool = False):
    """Per-slot distance and window halfwidth over the selected STR blocks,
    read in place (kernel B4, the pool engine ``inline``).

    Args:
      blk_idx: (Q, S) int32 flattened block ids, S = L*M, table l's block
        b stored as ``l*nb + b`` (ids outside [0, L*nb) are invalid slots).
      proj_blocks: (L*nb, B, K) f32; vec_blocks: (L*nb, B, d) f32;
      norm_blocks: (L*nb, B) f32 squared norms (+inf padded).
      g: (Q, L, K) f32; q: (Q, d) f32; M: blocks per table (slot s belongs
        to table s // M); exact: diff-form distances.

    Returns: d2 (Q, S*B), hw (Q, S*B) float32 ``max_k |p_k - g_k|``; both
    +inf on every slot of an invalid block, in both forms.
    """
    args = (blk_idx, proj_blocks, vec_blocks, norm_blocks, g, q)
    cuda = _on_cuda(*args)
    Qn, S = blk_idx.shape
    lnb, B, K = proj_blocks.shape
    d = vec_blocks.shape[-1]
    L = g.shape[1]
    if S != L * M:
        raise ValueError(f"S={S} slots but L*M={L * M}")
    f32 = torch.float32
    _check("blk_idx", blk_idx, torch.int32, (Qn, S))
    _check("proj_blocks", proj_blocks, f32, (lnb, B, K))
    _check("vec_blocks", vec_blocks, f32, (lnb, B, d))
    _check("norm_blocks", norm_blocks, f32, (lnb, B))
    _check("g", g, f32, (Qn, L, K))
    _check("q", q, f32, (Qn, d))
    if not cuda:
        return window_dist_ref(*args, M=M, exact=exact)
    return _dist_launch(
        "window_dist", q, K, S * B,
        lambda lib, q2, d2, hw, stream: lib.window_dist_launch(
            *map(_ptr, args), q2, d2, hw, Qn, S, M, lnb, B, K, d, L, int(exact), stream),
    )


def candidate_dist(cand_proj, cand_vecs, cand_norms, g, q, *, exact: bool = False):
    """Per-slot distance and window halfwidth over pre-gathered candidates
    (kernel B5, the pool engine ``kernel``).

    Args:
      cand_proj: (Q, L, Ct, K) f32 (+inf on invalid slots); cand_vecs:
        (Q, L, Ct, d) f32; cand_norms: (Q, L, Ct) f32 squared norms (+inf
        on invalid slots); g: (Q, L, K) f32; q: (Q, d) f32; exact:
        diff-form distances.

    Returns: d2 (Q, L*Ct), hw (Q, L*Ct) float32, table-major; hw = +inf on
    a +inf projection, d2 = +inf on a +inf norm in norm form (the diff
    form computes the slot's real distance).
    """
    args = (cand_proj, cand_vecs, cand_norms, g, q)
    cuda = _on_cuda(*args)
    Qn, L, Ct, K = cand_proj.shape
    d = cand_vecs.shape[-1]
    f32 = torch.float32
    _check("cand_proj", cand_proj, f32, (Qn, L, Ct, K))
    _check("cand_vecs", cand_vecs, f32, (Qn, L, Ct, d))
    _check("cand_norms", cand_norms, f32, (Qn, L, Ct))
    _check("g", g, f32, (Qn, L, K))
    _check("q", q, f32, (Qn, d))
    if not cuda:
        return candidate_dist_ref(*args, exact=exact)
    return _dist_launch(
        "candidate_dist", q, K, L * Ct,
        lambda lib, q2, d2, hw, stream: lib.candidate_dist_launch(
            *map(_ptr, args), q2, d2, hw, Qn, L, Ct, K, d, int(exact), stream),
    )


def pairwise_l2(Q, X):
    """Squared-L2 distance matrix ``max(||q||^2 - 2 q.x + ||x||^2, 0)``
    (kernel B8).  The kernel's tile is its own constant: the reference's
    TPU tile arguments have no counterpart.

    Args:
      Q: (nq, d), X: (nn, d), both float32 or both bf16, contiguous.

    Returns: (nq, nn) float32; bf16 products on the tensor cores, float32
    products on the FMA units (never TF32), summed in float32, the clamp at
    0 applied once.
    """
    cuda = _on_cuda(Q, X)
    if Q.dim() != 2 or X.dim() != 2:
        raise ValueError(f"pairwise_l2 takes two matrices, got {Q.dim()}-d and {X.dim()}-d")
    if Q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"Q: dtype {Q.dtype}, expected torch.float32 or torch.bfloat16")
    nq, d = Q.shape
    nn = X.shape[0]
    _check("Q", Q, Q.dtype, (nq, d))
    _check("X", X, Q.dtype, (nn, d))
    if not cuda:
        return pairwise_l2_ref(Q, X)
    # the grid's y extent counts X's row tiles (128 rows, or 256 in float32
    # with nq <= 64), its x extent Q's: one limit for both input types
    bf16 = Q.dtype == torch.bfloat16
    if nn > _MAX_GRID_Y * 128 or max(nq, nn) >= 2**31 - 128:
        raise ValueError(f"pairwise_l2: nq={nq} or nn={nn} too large for one launch")
    lib = _build.load()
    out = torch.empty((nq, nn), dtype=torch.float32, device=Q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(Q.device):
        err = lib.pairwise_l2_launch(_ptr(Q), _ptr(X), _ptr(out), nq, nn, d, int(bf16),
                                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _raise_on(lib, err, "pairwise_l2")
    launches["pairwise_l2"] += 1
    return out


def select_blocks(mbr_lo, mbr_hi, g, half: float, *, M: int):
    """MINDIST-ordered block selection of every table in one pass over the
    MBRs (kernel S1).

    Args:
      mbr_lo, mbr_hi: (L, nb, K) f32 block bounding boxes; g: (Q, L, K) f32
        query projections; half: the window's half width (taken in
        float32, as torch takes a Python scalar); M >= 1: blocks kept a
        table, of which at most nb are (the twin's sort has nb columns).

    Returns: blk (L, Q, min(M, nb)) int32, the overlapping blocks of
    smallest MINDIST in ascending (MINDIST, index) order (``nb`` where
    fewer overlap), and bhw (L, Q, min(M, nb)) f32, their L∞ box distances
    to g (+inf on those slots): :func:`ref.select_blocks_ref`'s outputs,
    bit for bit where K < 128.
    """
    if not _on_cuda(mbr_lo, mbr_hi, g):
        return select_blocks_ref(mbr_lo, mbr_hi, g, half, M=M)
    L, nb, K = mbr_lo.shape
    Qn = g.shape[0]
    f32 = torch.float32
    _check("mbr_lo", mbr_lo, f32, (L, nb, K))
    _check("mbr_hi", mbr_hi, f32, (L, nb, K))
    _check("g", g, f32, (Qn, L, K))
    if M < 1 or K < 1:
        raise ValueError(f"select_blocks: M={M} or K={K} below 1")
    M = min(M, nb)
    blk = torch.empty((L, Qn, M), dtype=torch.int32, device=g.device)
    bhw = torch.empty((L, Qn, M), dtype=f32, device=g.device)
    if Qn == 0 or M == 0:
        return blk, bhw
    lib = _build.load()
    part = torch.empty((lib.select_scratch_keys(Qn, L, nb, K, M),), dtype=torch.int64,
                       device=g.device)
    with torch.cuda.device(g.device):
        err = lib.select_blocks_launch(
            *map(_ptr, (mbr_lo, mbr_hi, g)), float(half), *map(_ptr, (part, blk, bhw)),
            Qn, L, nb, K, M, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _raise_on(lib, err, "select_blocks")
    launches["select_blocks"] += 1
    return blk, bhw


@functools.lru_cache(maxsize=256)
def _merge_smem(k: int, kb: int) -> int:
    """Shared memory one block of M1 asks for at these widths: a function
    of the widths alone, asked once."""
    return _build.load().merge_smem_bytes(k, kb)


def merge_schedule(bins_d, bins_i, bhw, cum_adm, sched, *, k: int, n: int, B: int,
                   c1_thr=None, use_c2: bool = True, early_exit: bool = False,
                   with_stats: bool = False, with_explain: bool = False):
    """The one-pass search's whole merge schedule in one launch (kernel
    M1): per query and step, the stats, the dedup'd top-k merge of the
    step's bin and the C2 then C1 done marks, a done query frozen.

    Args:
      bins_d, bins_i: (Q, S, kb) f32 / int32, bin j the (d2, id) pairs of
        the slots first admitted at step j, in any order (non-finite d2
        never enter).
      bhw: (Q, T) f32 the selected blocks' window halfwidths, given
        exactly when ``with_stats`` (or ``with_explain``) is.
      cum_adm: (Q, S) int64 admitted slots of bins 0..j, given exactly
        when ``c1_thr`` (C1's budget) is.
      sched: (3, S) f32, per step the half width, C2's bound (c·r)² and
        the radius.
      k: top-k; n: the id of unfilled slots; B: slots a block; use_c2:
        the C2 rule; early_exit: the twin's host exit once every query
        is done (on the card each query stops at its own done step and
        the host reads nothing).

    Returns (best_d, best_i, stats): (Q, k) squared distances ascending
    and int32 ids (``n`` unfilled), and the stats of
    :func:`ref.merge_schedule_ref` (None without ``with_stats``).  Every
    output is the twin's, bit for bit.
    """
    with_stats = with_stats or with_explain
    tensors = [t for t in (bins_d, bins_i, bhw, cum_adm, sched) if t is not None]
    cuda = _on_cuda(*tensors)
    if bins_d.dim() != 3:
        raise ValueError(f"bins_d: {bins_d.dim()}-d, expected (Q, S, kb)")
    Qn, S, kb = bins_d.shape
    if k < 1 or S < 1 or kb < 1:
        raise ValueError(f"merge_schedule: k={k}, S={S} or kb={kb} below 1")
    if (bhw is None) == with_stats:
        raise ValueError("bhw is given exactly when the stats are asked for")
    if (cum_adm is None) != (c1_thr is None):
        raise ValueError("cum_adm is given exactly with c1_thr")
    f32, i32 = torch.float32, torch.int32
    _check("bins_d", bins_d, f32, (Qn, S, kb))
    _check("bins_i", bins_i, i32, (Qn, S, kb))
    _check("sched", sched, f32, (3, S))
    if bhw is not None:
        if bhw.dim() != 2:
            raise ValueError(f"bhw: {bhw.dim()}-d, expected (Q, T)")
        _check("bhw", bhw, f32, (Qn, bhw.shape[1]))
    if cum_adm is not None:
        _check("cum_adm", cum_adm, torch.int64, (Qn, S))
    _check_k(k, n)
    kw = dict(k=k, n=n, B=B, c1_thr=c1_thr, use_c2=use_c2, early_exit=early_exit,
              with_stats=with_stats, with_explain=with_explain)
    if not cuda:
        return merge_schedule_ref(bins_d, bins_i, bhw, cum_adm, sched, **kw)[:3]

    smem = _merge_smem(k, kb)
    if smem > _MAX_SMEM:
        raise ValueError(f"merge_schedule: k={k}, kb={kb} need {smem} bytes of shared "
                         f"memory; the kernel takes at most {_MAX_SMEM}")
    dev = bins_d.device
    best_d = torch.empty((Qn, k), dtype=f32, device=dev)
    best_i = torch.empty((Qn, k), dtype=i32, device=dev)
    stats = None
    if with_stats:
        stats = {"radius_steps": torch.empty((Qn,), dtype=i32, device=dev),
                 "candidates": torch.empty((Qn,), dtype=i32, device=dev)}
    if with_explain:
        stats.update(step_slots=torch.empty((Qn, S), dtype=i32, device=dev),
                     term_cause=torch.empty((Qn,), dtype=i32, device=dev),
                     final_radius=torch.empty((Qn,), dtype=f32, device=dev))
    if Qn == 0:
        return best_d, best_i, stats
    st = stats or {}
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.merge_schedule_launch(
            *map(_ptr, (bins_d, bins_i, bhw, cum_adm, sched, best_d, best_i,
                        st.get("radius_steps"), st.get("candidates"), st.get("step_slots"),
                        st.get("term_cause"), st.get("final_radius"))),
            0 if c1_thr is None else int(c1_thr), int(use_c2), Qn, S, kb, k,
            0 if bhw is None else bhw.shape[1], B, n,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _raise_on(lib, err, "merge_schedule")
    launches["merge_schedule"] += 1
    return best_d, best_i, stats
