"""Fused glimpse attention, the port of ``vqa_tpu/ops/attention.py``
(``glimpse_head`` and ``glimpse_attend``).

glimpse_head(joint [B, R, M], w [M, G], b [G], v [B, R, D])
    -> (attended [B, G, D], logits [B, R, G])
glimpse_attend(logits [B, R, G], v [B, R, D]) -> attended [B, G, D]

logits = joint·w + b (or given), softmax over axis 1, attended = alphaᵀ·v.
Both forwards are registered ops (``torch.ops.vqa_tpu_torch.glimpse_head``
and ``.glimpse_attend``): on CUDA tensors they launch the hand-written
kernel in ``csrc/glimpse_head.cu`` (glimpse_attend is its logits-given
entry) with the schedule ``glimpse_plan`` gives: bf16 operands through the
bf16 designs (past alpha [R, G] in shared memory, the two wgmma kernels of
``csrc/glimpse_tc.cu``), float32 operands through the float32 entries
(nothing rounded, as the Pallas kernels compute in their input's dtype); on
CPU tensors they take the plain version. Each wrapper counts its own
launches, and its calls by design in ``design_launches``.

Where an input asks for grads, each call is a ``torch.autograd.Function``:
the same forward, and a backward by autograd through the plain version on
the saved inputs (a recompute), as ``vqa_tpu/ops/attention.py``'s ``_bwd``
and ``_head_bwd`` take the vjp of their jnp references. Both outputs of
glimpse_head are differentiable. Logits masked at ``finfo.min`` (MFB's
question self-attention) take a zero grad, and a row masked whole takes
uniform weights and finite grads.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vqa_tpu_torch.ops import (KERNEL_DTYPES, MAX_MERGE_CHUNKS, SMEM_LIMIT, _build, lse_merge,
                               recompute_grads, register)

SMS = 132               # streaming multiprocessors of an H100 SXM
# csrc/glimpse_head.cu's constants, and the plan's targets
_GROUP = 4              # glimpses a thread accumulates at once
_MAX_SPLIT = 8          # the portable cluster size
_MIN_COLS = 512         # columns a split CTA keeps (128 items a glimpse group)
_CTA_BYTES = 80 * 1024  # split a row's D while its v is more than this
_STAGE_BYTES = 16 * 1024      # a ring stage
_RESIDENT_BYTES = 96 * 1024   # the most v a CTA holds at once; past it, a ring of
_RING = 4                     # this many stages
_JOINT_BYTES = 32 * 1024      # w and a CTA's joint slice staged in shared memory up to this
_TX_LIMIT = (1 << 20) - 1     # bytes one mbarrier phase can await
_COPY = {"plain": 0, "bulk": 1, "parent": 2}  # csrc/glimpse_head.cu's kMode*
DESIGNS = (*_COPY, "f32", "split", "tc")      # every plan's "copy"
_PARENT_MAX_G = 4             # accumulators a thread of the parent kernel keeps
# csrc/glimpse_tc.cu's constants: the weighted sum's glimpse widths (wgmma's
# N), its regions a stage, columns a CTA and v's box (64 regions x 128
# bytes); the logits kernel's region tiles and threads
_TC_N = (8, 16, 24, 32, 64, 128)
_TC_STAGE = 64
_TC_COLS = 128
_TC_VBOX = 64 * 128
_TC_ROWS = (64, 32, 16)
_TC_LOGIT_THREADS = 256


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _align16(x: int) -> int:
    return _ceil(x, 16) * 16


def _smem_bytes(R: int, M: int, G: int, dc: int, split: int, chunk: int, stages: int,
                staged: bool) -> int:
    """csrc/glimpse_head.cu's layout().total: the barriers, alpha [R, G
    rounded up to 4] in fp32, the bias, where ``staged`` w and the CTA's
    joint slice (its ceil(R / split) regions), the ring (exactly R regions
    when it holds every chunk)."""
    gp = _ceil(G, _GROUP) * _GROUP
    regions = R if stages >= _ceil(R, chunk) else stages * chunk
    w = _align16(M * G * 2 + 16) if staged else 0
    seg = _align16(_ceil(R, split) * M * 2 + 16) if staged else 0
    return (_align16((stages + 1) * 8) + _align16(R * gp * 4) + _align16(gp * 4) + w + seg
            + _align16(regions * dc * 2))


def _split_plan(B: int, R: int, G: int, D: int, smem_limit: int, sms: int = SMS) -> dict:
    """The split design (either type): a block a (batch row, group of
    ``groups`` glimpses, chunk of the regions), holding alpha [chunk,
    groups] in fp32. Every region in one chunk where alpha [R, min(G, 4)]
    fits, the glimpses in groups (multiples of 4) small enough that the
    blocks fill twice the ``sms`` SMs, where that many fit; past that,
    groups of 4 glimpses and the regions in chunks, as many as fill the
    SMs twice (up to chunks of 256 regions) and at least the fewest that
    fit, their partials merged by their log-sum-exp (fp32 scratch [B G,
    chunks, D] and [B G, chunks, 2]). Raises ValueError where even one
    region of one group cannot fit."""
    floats, target = smem_limit // 4, 2 * sms
    if R * min(G, _GROUP) <= floats:  # every region in one block
        most = G if G <= _GROUP else min(G, floats // R // _GROUP * _GROUP)
        groups = min(most, max(_GROUP, _ceil(_ceil(B * G, target), _GROUP) * _GROUP))
    else:
        groups = min(G, _GROUP)
    n_groups = _ceil(G, groups)
    groups = min(G, _ceil(_ceil(G, n_groups), _GROUP) * _GROUP)  # the same groups, evened
    if groups > floats:
        raise ValueError(f"glimpse kernels: {groups} glimpses of one region need "
                         f"{4 * groups} bytes of shared memory, over the {smem_limit} a "
                         f"block may opt into")
    chunks = _ceil(R, floats // groups)
    if chunks > 1:  # the regions split anyway: enough chunks to fill the SMs
        chunks = max(chunks, min(_ceil(target, B * n_groups), _ceil(R, 256)))
    chunk = _ceil(R, chunks)
    chunks = _ceil(R, chunk)  # the same chunks, evened
    if chunks > MAX_MERGE_CHUNKS:
        raise ValueError(f"glimpse kernels: {R} regions need {chunks} chunks, over the "
                         f"{MAX_MERGE_CHUNKS} one merge takes")
    return {"copy": "split", "split": 1, "chunk": chunk, "stages": 1, "staged": False,
            "resident": False, "groups": groups, "chunks": chunks,
            "smem_bytes": chunk * groups * 4, "ctas": B * n_groups * chunks,
            "scratch_bytes": B * G * chunks * (D + 2) * 4 if chunks > 1 else 0,
            "design": "split: a block a (row, group of glimpses, chunk of regions), alpha "
                      "[chunk, group] in shared memory, v and w from device memory, chunks "
                      "merged by their log-sum-exp"}


def _tc_logits_smem(rows: int, ln: int, M: int) -> int:
    """csrc/glimpse_tc.cu's logits_layout().total: the barrier, the bias,
    the statistics' partials (a pair a thread), the K parts' products [128,
    ln] fp32, and for glimpse_head (M > 0) w^T [ln, M rounded up to 16, + 8]
    bf16 and the joint tile with its lead."""
    s = 16 + _align16(ln * 4) + _TC_LOGIT_THREADS * 8 + 128 * ln * 4
    if M:
        s += ln * (_ceil(M, 16) * 16 + 8) * 2 + _align16(rows * M * 2 + 32)
    return s


def _tc_sum_smem(n: int, stages: int) -> int:
    """csrc/glimpse_tc.cu's SumLayout<n>::total: (m, l) of n glimpses and the
    ring's barriers, 1 KB to align the ring, and each stage's v boxes,
    alpha^T [n, 64] bf16 and fp32 logits [64, n]."""
    stage = 2 * _TC_VBOX + n * 128 + _TC_STAGE * n * 4
    return _align16(8 * n + 16 * stages) + 1024 + stages * stage


def _tc_plan(B: int, R: int, M: int, G: int, D: int, smem_limit: int, sms: int) -> dict | None:
    """The "tc" design (bf16, v loadable by TMA), or None where its shared
    memory does not fit ``smem_limit``. ``groups``: the glimpses a group
    (the weighted sum's wgmma N: G rounded up to one of ``_TC_N``; groups of
    128 past it); ``ln`` and ``rows``: the logits kernel's tiles of
    glimpses (up to 64) and regions (64), fewer where joint's rows are
    wide, its CTAs each walking tiles (``logits``);
    the weighted sum a CTA a (row, group, 128 columns of d, chunk of the
    regions) over ``stages`` stages of 64 regions (the most up to 4 that
    leave two CTAs on an SM, where three do), the regions in ``chunks`` only
    where those CTAs leave SMs idle. Scratch (``scratch_bytes``): the fp32
    logits [B, groups, R rounded up to 64, n], the tile statistics [B,
    groups n, ceil(R / rows), 2] and, with chunks, the partials [chunks, B,
    G, D]."""
    n = next((w for w in _TC_N if w >= G), _TC_N[-1])
    n_groups = _ceil(G, n)
    # the most glimpses, then the most regions, a logits CTA holds (joint is
    # read once a tile of ln glimpses)
    tiles = [(ln, rows) for ln in (64, 32, 24, 16, 8) if ln <= n and n % ln == 0
             for rows in _TC_ROWS if _tc_logits_smem(rows, ln, M) <= smem_limit]
    fits = [st for st in (4, 3, 2) if _tc_sum_smem(n, st) <= smem_limit]
    if not tiles or not fits:
        return None
    ln, rows = tiles[0]

    def two(smem: int) -> bool:  # two CTAs on an SM (each also holds 1 KB)
        return 2 * (smem + 1024) <= smem_limit + 1024

    stages = next((st for st in fits if st >= 3 and two(_tc_sum_smem(n, st))), fits[0])
    smem = _tc_sum_smem(n, stages)
    fill = (2 if two(smem) else 1) * sms
    n_rt = _ceil(R, _TC_STAGE)
    ctas = B * n_groups * _ceil(D, _TC_COLS)
    chunks = min(n_rt, _ceil(fill, ctas)) if ctas < fill else 1
    chunk_stages = _ceil(n_rt, chunks)
    chunks = _ceil(n_rt, chunk_stages)  # the same chunks, evened
    rtiles, n_gt = _ceil(R, rows), n_groups * n // ln
    slots = max(1, min(B * rtiles, _ceil(2 * sms, n_gt)))
    return {"copy": "tc", "split": 1, "chunk": chunk_stages * _TC_STAGE, "stages": stages,
            "groups": n, "rows": rows, "ln": ln, "chunks": chunks,
            "smem_bytes": smem, "ctas": ctas * chunks, "threads": 288,
            "logits": {"ctas": n_gt * slots, "slots": slots, "threads": _TC_LOGIT_THREADS,
                       "smem_bytes": _tc_logits_smem(rows, ln, M)},
            "scratch_bytes": (B * n_groups * n_rt * _TC_STAGE * n * 4
                              + B * n_groups * n * rtiles * 8
                              + (chunks * B * G * D * 4 if chunks > 1 else 0)),
            "design": "tc: the logits on mma.sync over bulk-copied joint tiles into fp32 scratch "
                      "with each tile's (max, sum of exp), then the weighted sum on wgmma, v read "
                      "once by TMA, alpha rounded once to bf16"}


def _past_shared_memory(B: int, R: int, M: int, G: int, D: int, vec: bool, smem_limit: int,
                        sms: int) -> dict:
    """bf16 past alpha [R, G] in shared memory: the tc design where TMA can
    load v and its shared memory fits, else the split design."""
    tc = _tc_plan(B, R, M, G, D, smem_limit, sms) if vec else None
    return tc if tc is not None else _split_plan(B, R, G, D, smem_limit, sms)


def _f32_plan(B: int, R: int, M: int, G: int, D: int, smem_limit: int, sms: int) -> dict:
    """The float32 entries' design where alpha [R, G] fits: a block a row,
    alpha in shared memory and w [M, G] beside it where both fit; past it,
    the split design."""
    alpha, w = R * G * 4, M * G * 4
    if alpha > smem_limit:
        return _split_plan(B, R, G, D, smem_limit, sms)
    staged = M > 0 and alpha + w <= smem_limit
    return {"copy": "f32", "split": 1, "chunk": R, "stages": 1, "staged": staged,
            "resident": False, "smem_bytes": alpha + (w if staged else 0), "ctas": B,
            "design": "float32: one block a row, w in shared memory, v streamed from device "
                      "memory a group of 4 glimpses at a time"}


@functools.lru_cache(maxsize=1024)
def glimpse_plan(B: int, R: int, M: int, G: int, D: int, vec: bool = True,
                 smem_limit: int = SMEM_LIMIT, sms: int = SMS, copy: str | None = None,
                 split: int | None = None, elem: int = 2) -> dict:
    """The schedule ``csrc/glimpse_head.cu`` runs for B batch rows of R
    regions, M joint features (0 for glimpse_attend), G glimpses and D
    columns of v, in elements of ``elem`` bytes: 2 (bf16) takes the
    designs below; 4 (float32) the float32 entries' one design (a block a
    row, ``copy`` "f32", ``staged``: w in shared memory beside alpha), at
    any R and G whose alpha [R, G] fits; past it, the split design. For
    bf16, ``copy`` names the design:

    - "parent": the one-block-a-row kernel the file held before the ring,
      where it measured fastest on the card (PERF.md, Findings):
      glimpse_head at >= 4 x ``sms`` rows and G <= 4;
    - "bulk": the ring. ``split``: a row's D columns over a cluster of CTAs
      (the logits computed once, each CTA taking its share of the regions,
      and shared through DSMEM), while a row's v is over 80 KB (D=2048: 2),
      and again while B x split CTAs leave SMs idle (the serving batch);
      each CTA keeps >= 512 columns on a multiple of 8. ``staged``:
      glimpse_head's w and joint slice copied into shared memory ahead of v
      (up to 32 KB), else read from device memory. ``chunk`` regions a
      stage (~16 KB), ``stages`` stages: all of a CTA's v at once
      (``resident``) up to 96 KB, else 4 stages refilled as they drain;
    - "plain" (``vec=False``: D % 8 != 0, or a pointer off 16 bytes): the
      ring's generic path, one CTA a row, one stage of plain copies;
    - "tc" (bf16, ``vec``), where alpha [R, G] and one region of the ring
      exceed ``smem_limit`` (R=3136 with 24 glimpses, R=196 with G=512,
      R=16,384): the two kernels of csrc/glimpse_tc.cu, the logits on
      mma.sync into fp32 scratch with each tile's (max, sum of exp), then
      the weighted sum on wgmma, v read once by TMA (``_tc_plan``);
    - "split" (either type), there where "tc" cannot run (``vec=False``,
      float32, or its shared memory past ``smem_limit``), or where forced:
      a block a (row, group of ``groups`` glimpses, chunk of the regions),
      alpha [chunk, groups] in shared memory, v read from device memory; the
      regions split into ``chunks`` only past alpha [R, 4] (R > ~14,500),
      those chunks merged by their log-sum-exp.

    ``copy`` ("parent", "bulk", "plain", and "split" in either type) and
    ``split`` may be forced, to probe other schedules. Raises ValueError,
    naming the limit, where even one region of one glimpse group exceeds
    ``smem_limit`` (the shared memory a block may opt into on the card).
    Cached: the wrappers ask for it at every call; the dict is shared, not
    to be changed."""
    if min(B, R, G, D) < 1 or M < 0:
        raise ValueError(f"glimpse kernels need B, R, G, D >= 1 and M >= 0, got B={B}, R={R}, "
                         f"M={M}, G={G}, D={D}")
    if copy == "split" and elem in (2, 4):
        return _split_plan(B, R, G, D, smem_limit, sms)
    if elem == 4:
        return _f32_plan(B, R, M, G, D, smem_limit, sms)
    if elem != 2:
        raise ValueError(f"glimpse kernels take 2-byte (bf16) or 4-byte (float32) elements, "
                         f"got {elem}")
    row_bytes = R * D * 2
    parent_smem = (M + R) * G * 4
    if copy is None:
        copy = ("parent" if M > 0 and G <= _PARENT_MAX_G and B >= 4 * sms
                and parent_smem <= smem_limit else "bulk" if vec else "plain")
    if copy == "parent":
        if G > _PARENT_MAX_G or parent_smem > smem_limit:
            raise ValueError(f"glimpse kernels: the parent kernel takes G <= {_PARENT_MAX_G} and "
                             f"{parent_smem} bytes of shared memory within {smem_limit}")
        return {"copy": copy, "split": 1, "chunk": R, "stages": 1, "staged": False,
                "resident": False, "smem_bytes": parent_smem, "ctas": B,
                "design": "one block a row, v streamed from device memory (the parent kernel)"}

    def can_split(s: int) -> bool:
        return vec and s <= _MAX_SPLIT and D % (8 * s) == 0 and D // s >= _MIN_COLS

    if split is None:
        split = 1
        while row_bytes > _CTA_BYTES * split and can_split(2 * split):
            split *= 2
        while B * split < sms and can_split(2 * split):
            split *= 2
    dc = D // split
    joint_bytes = _align16(M * G * 2 + 16) + _align16(_ceil(R, split) * M * 2 + 16)
    staged = vec and M > 0 and joint_bytes <= _JOINT_BYTES
    chunk = max(1, min(R, _STAGE_BYTES // (2 * dc)))
    chunk = _ceil(R, _ceil(R, chunk))  # the same stages, evened out
    n_chunks = _ceil(R, chunk)
    stages = 1 if not vec else n_chunks if R * dc * 2 <= _RESIDENT_BYTES else min(_RING, n_chunks)
    while _smem_bytes(R, M, G, dc, split, chunk, stages, staged) > smem_limit:
        if staged:
            staged = False
        elif stages > 1:
            stages -= 1
        elif chunk > 1:
            chunk = _ceil(chunk, 2)
        else:  # alpha [R, G] and one region of the ring do not fit
            return _past_shared_memory(B, R, M, G, D, vec, smem_limit, sms)
    if chunk * dc * 2 > _TX_LIMIT:  # a stage past what one mbarrier phase can await
        return _past_shared_memory(B, R, M, G, D, vec, smem_limit, sms)
    return {"copy": "bulk" if vec else "plain", "split": split, "chunk": chunk,
            "stages": stages, "staged": staged, "resident": stages >= _ceil(R, chunk),
            "smem_bytes": _smem_bytes(R, M, G, dc, split, chunk, stages, staged),
            "ctas": B * split,
            "design": "v, w and joint's slice by bulk copies first, a cluster split over D, "
                      "DSMEM logits"}


def _vec(D: int, *tensors) -> bool:
    return D % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def glimpse_attend_reference(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("brg,brd->bgd", torch.softmax(logits, dim=1), v)


def glimpse_attend_split_model(logits: torch.Tensor, v: torch.Tensor,
                               chunks: int) -> torch.Tensor:
    """The split design's arithmetic in plain PyTorch, to hold the
    split-and-merge against the reference: the regions in ``chunks``
    chunks of ceil(R / chunks), each chunk's unnormalised weighted sum with
    its max and sum of exp a glimpse, merged by ``lse_merge`` (alpha
    unrounded, as the kernel's merge takes it)."""
    R = logits.shape[1]
    chunk = -(-R // chunks)
    parts, ms, ls = [], [], []
    for r0 in range(0, R, chunk):
        lc = logits[:, r0:r0 + chunk]                      # [B, c, G]
        m = lc.amax(1)                                     # [B, G]
        p = torch.exp(lc - m.unsqueeze(1))
        parts.append(torch.einsum("brg,brd->bgd", p, v[:, r0:r0 + chunk]))
        ms.append(m)
        ls.append(p.sum(1))
    return lse_merge(torch.stack(parts, -2), torch.stack(ms, -1), torch.stack(ls, -1))


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in its accumulation type: fp32 for bf16 and float32, else its own."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def glimpse_tc_logits_model(joint: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """The tc design's logits in plain PyTorch: joint·w + b in fp32 (the
    Pallas kernel's dot, then the bias), unrounded."""
    return _acc(joint) @ _acc(w) + _acc(b)


def glimpse_tc_stats_model(logits: torch.Tensor, rows: int) -> torch.Tensor:
    """Each (row, glimpse)'s (max, sum of exp) over each tile of ``rows``
    regions of ``logits`` [B, R, G]: stats [B, G, tiles, 2] (the logits
    kernel's, csrc/lse_merge.cuh's convention)."""
    tiles = logits.split(rows, dim=1)
    m = torch.stack([t.amax(1) for t in tiles], -1)
    l = torch.stack([torch.exp(t - mt.unsqueeze(1)).sum(1)
                     for t, mt in zip(tiles, m.unbind(-1))], -1)
    return torch.stack([m, l], -1)


def glimpse_tc_sum_model(logits: torch.Tensor, stats: torch.Tensor, v: torch.Tensor,
                         chunks: int = 1) -> torch.Tensor:
    """The tc design's weighted sum in plain PyTorch: each glimpse's tile
    statistics merged in tile order (m = max_t m_t, l = sum_t l_t
    e^(m_t - m)), alpha = exp(logits - m) / l rounded once to v's dtype,
    the sum in fp32 over ``chunks`` chunks of whole 64-region stages, added
    in chunk order, the output rounded once."""
    mc, lc = stats.unbind(-1)
    m = mc.amax(-1)
    l = (lc * torch.exp(mc - m.unsqueeze(-1))).sum(-1)
    alpha = _acc((torch.exp(logits - m.unsqueeze(1)) / l.unsqueeze(1)).to(v.dtype))
    vv = _acc(v)
    chunk = _ceil(_ceil(v.shape[1], _TC_STAGE), chunks) * _TC_STAGE
    out = None
    for r0 in range(0, v.shape[1], chunk):
        part = torch.einsum("brg,brd->bgd", alpha[:, r0:r0 + chunk], vv[:, r0:r0 + chunk])
        out = part if out is None else out + part
    return out.to(v.dtype)


def glimpse_tc_model(logits: torch.Tensor, v: torch.Tensor, rows: int = 64,
                     chunks: int = 1) -> torch.Tensor:
    """The tc design's arithmetic in plain PyTorch, to hold it against the
    reference and the Pallas kernels: the logits (``logits`` in their
    accumulation type: the fp32 logits glimpse_head computes, or those
    given) in tiles of ``rows`` regions with their statistics, then the
    weighted sum (``glimpse_tc_sum_model``)."""
    logits = _acc(logits)
    return glimpse_tc_sum_model(logits, glimpse_tc_stats_model(logits, rows), v, chunks)


def _tc_scratch_sizes(B: int, R: int, G: int, D: int, plan: dict) -> tuple:
    """The floats of the tc design's three scratch arrays: the logits [B,
    groups, R rounded up to 64, n], the tile statistics [B, groups n,
    ceil(R / rows), 2] and, with chunks, the partials [chunks, B, G, D]
    (else 0). Each is a multiple of 16 floats (the logits' rows are whole
    64-region stages, n a multiple of 8), so each starts on 16 bytes."""
    n, chunks = plan["groups"], plan["chunks"]
    n_groups = _ceil(G, n)
    return (B * n_groups * _ceil(R, _TC_STAGE) * _TC_STAGE * n,
            B * n_groups * n * _ceil(R, plan["rows"]) * 2,
            chunks * B * G * D if chunks > 1 else 0)


def tc_scratch(B: int, R: int, G: int, D: int, device, plan: dict) -> torch.Tensor:
    """The tc design's fp32 scratch on ``device``: one allocation holding
    the arrays of ``_tc_scratch_sizes`` one after another."""
    return torch.empty(sum(_tc_scratch_sizes(B, R, G, D, plan)), dtype=torch.float32,
                       device=device)


def tc_launch_geometry(B: int, R: int, M: int, G: int, D: int, plan: dict,
                       device_index: int) -> dict:
    """What csrc/glimpse_tc.cu launches for the tc ``plan`` at this shape
    (M = 0: glimpse_attend), by its own reckoning: the logits kernel's CTAs,
    threads and shared memory, and the weighted sum's under "weighted"."""
    geometry = (ctypes.c_longlong * 3)()
    launches = []
    with torch.cuda.device(device_index):
        for which in (0, 1):
            _build.check(_build.library().vqa_glimpse_tc_geometry(
                B, R, M, G, D, plan["groups"], plan["rows"], plan["ln"], plan["stages"],
                plan["chunks"], plan["logits"]["slots"], which, geometry), "glimpse tc geometry")
            launches.append(dict(zip(("ctas", "threads", "smem_bytes"), geometry)))
    return {**launches[0], "weighted": launches[1]}


def _launch_tc(joint, w, b, logits_in, v, attended, logits_out, plan: dict,
               launches: tuple = (0, 1), scratch: torch.Tensor | None = None) -> None:
    """The tc design's ``launches`` (0 the logits, 1 the weighted sum), in
    one call of its entry, for glimpse_head where ``joint`` is given, else
    glimpse_attend on ``logits_in``, over ``scratch`` (``tc_scratch``'s;
    allocated here if None)."""
    B, R, D = v.shape
    G = attended.shape[1]
    n_lg, n_stats, n_part = _tc_scratch_sizes(B, R, G, D, plan)
    if scratch is None:
        scratch = torch.empty(n_lg + n_stats + n_part, dtype=torch.float32, device=v.device)
    lg = scratch.data_ptr()

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.library().vqa_glimpse_tc(
        ptr(joint), ptr(w), ptr(b), ptr(logits_in), v.data_ptr(), attended.data_ptr(),
        ptr(logits_out), lg, lg + 4 * n_lg, lg + 4 * (n_lg + n_stats) if n_part else None, B, R,
        0 if joint is None else joint.shape[2], G, D, plan["groups"], plan["rows"], plan["ln"],
        plan["stages"], plan["chunks"], plan["logits"]["slots"], sum(1 << k for k in launches),
        _build.current_stream(v.device))
    _build.check(err, "glimpse_head" if joint is not None else "glimpse_attend")


def _launch_split(joint, w, b, logits_in, v, attended, logits_out, plan: dict) -> None:
    """One call of the split design's entry (glimpse_head where ``joint``
    is given, else glimpse_attend on ``logits_in``), its scratch allocated
    here where the regions are split."""
    B, R, _ = v.shape
    G, D = attended.shape[1], attended.shape[2]
    chunks = plan["chunks"]
    part = stats = None
    if chunks > 1:
        part = torch.empty(B * G * chunks * D, dtype=torch.float32, device=v.device)
        stats = torch.empty(B * G * chunks * 2, dtype=torch.float32, device=v.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.library().vqa_glimpse_split(
        ptr(joint), ptr(w), ptr(b), ptr(logits_in), v.data_ptr(), attended.data_ptr(),
        ptr(logits_out), ptr(part), ptr(stats), B, R, 0 if joint is None else joint.shape[2], G,
        D, plan["groups"], chunks, v.dtype.itemsize, _build.current_stream(v.device))
    _build.check(err, "glimpse_head" if joint is not None else "glimpse_attend")


def launch_glimpse_attend(logits: torch.Tensor, v: torch.Tensor, attended: torch.Tensor,
                          plan: dict) -> None:
    """One launch of the logits-given entry with ``plan``'s schedule (the
    float32 entry for a float32 plan; the split and the tc design each
    through its own entry)."""
    B, R, G = logits.shape
    if plan["copy"] == "tc":
        _launch_tc(None, None, None, logits, v, attended, None, plan)
        return
    if plan["copy"] == "split":
        _launch_split(None, None, None, logits, v, attended, None, plan)
        return
    if plan["copy"] == "f32":
        err = _build.library().vqa_glimpse_attend_f32(
            logits.data_ptr(), v.data_ptr(), attended.data_ptr(), B, R, G, v.shape[2],
            _build.current_stream(v.device))
        _build.check(err, "glimpse_attend")
        return
    err = _build.library().vqa_glimpse_attend(
        logits.data_ptr(), v.data_ptr(), attended.data_ptr(), B, R, G, v.shape[2],
        plan["split"], plan["chunk"], plan["stages"], _COPY[plan["copy"]],
        _build.current_stream(v.device),
    )
    _build.check(err, "glimpse_attend")


class _GlimpseAttend(torch.autograd.Function):
    """The registered op ``glimpse_attend`` (the kernel on the card), and the
    grads of ``glimpse_attend_reference`` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, logits, v):
        ctx.save_for_backward(logits, v)
        return _GLIMPSE_ATTEND_OP(logits, v)

    @staticmethod
    def backward(ctx, g):
        return recompute_grads(ctx, glimpse_attend_reference, (g,))


def glimpse_attend(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and (logits.requires_grad or v.requires_grad):
        return _GlimpseAttend.apply(logits, v)
    return _GLIMPSE_ATTEND_OP(logits, v)


def _glimpse_attend_cuda(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The op's CUDA implementation: check the operands, plan, launch, count."""
    if logits.ndim != 3 or v.ndim != 3:
        raise ValueError(f"expected logits [B, R, G] and v [B, R, D], got "
                         f"{tuple(logits.shape)}, {tuple(v.shape)}")
    B, R, G = logits.shape
    D = v.shape[2]
    dev, dt = logits.device, v.dtype
    _build.require("v", v, dev, KERNEL_DTYPES, (B, R, D))
    _build.require("logits", logits, dev, dt, (B, R, G))
    attended = torch.empty(B, G, D, dtype=dt, device=dev)
    if attended.numel() == 0:
        return attended
    plan = glimpse_plan(B, R, 0, G, D, vec=_vec(D, v, attended),
                        smem_limit=_build.smem_optin(dev.index or 0), elem=dt.itemsize)
    launch_glimpse_attend(logits, v, attended, plan)
    glimpse_attend.launches += 1
    glimpse_attend.design_launches[plan["copy"]] += 1
    return attended


def _glimpse_attend_fake(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return v.new_empty(logits.shape[0], logits.shape[2], v.shape[2])


glimpse_attend.launches = 0
glimpse_attend.design_launches = dict.fromkeys(DESIGNS, 0)  # the launches by design
_GLIMPSE_ATTEND_OP = register("glimpse_attend(Tensor logits, Tensor v) -> Tensor",
                              glimpse_attend_reference, _glimpse_attend_cuda,
                              _glimpse_attend_fake)


def glimpse_head_reference(joint: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           v: torch.Tensor):
    logits = joint @ w + b
    return glimpse_attend_reference(logits, v), logits


def launch_glimpse_head(joint, w, b, v, attended, logits, plan: dict) -> None:
    """One launch of glimpse_head with ``plan``'s schedule (the float32
    entry for a float32 plan; the split and the tc design each through its
    own entry)."""
    B, R, M = joint.shape
    if plan["copy"] == "tc":
        _launch_tc(joint, w, b, None, v, attended, logits, plan)
        return
    if plan["copy"] == "split":
        _launch_split(joint, w, b, None, v, attended, logits, plan)
        return
    if plan["copy"] == "f32":
        err = _build.library().vqa_glimpse_head_f32(
            joint.data_ptr(), w.data_ptr(), b.data_ptr(), v.data_ptr(), attended.data_ptr(),
            logits.data_ptr(), B, R, M, w.shape[1], v.shape[2], int(plan["staged"]),
            _build.current_stream(v.device))
        _build.check(err, "glimpse_head")
        return
    err = _build.library().vqa_glimpse_head(
        joint.data_ptr(), w.data_ptr(), b.data_ptr(), v.data_ptr(), attended.data_ptr(),
        logits.data_ptr(), B, R, M, w.shape[1], v.shape[2], plan["split"],
        plan["chunk"], plan["stages"], int(plan["staged"]), _COPY[plan["copy"]],
        _build.current_stream(v.device),
    )
    _build.check(err, "glimpse_head")


class _GlimpseHead(torch.autograd.Function):
    """The registered op ``glimpse_head`` (the kernel on the card), and the
    grads of ``glimpse_head_reference`` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, joint, w, b, v):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(joint, w, b, v)
        return _GLIMPSE_HEAD_OP(joint, w, b, v)

    @staticmethod
    def backward(ctx, g_att, g_logits):
        return recompute_grads(ctx, glimpse_head_reference, (g_att, g_logits))


def glimpse_head(joint: torch.Tensor, w: torch.Tensor, b: torch.Tensor, v: torch.Tensor):
    if torch.is_grad_enabled() and any(x.requires_grad for x in (joint, w, b, v)):
        return _GlimpseHead.apply(joint, w, b, v)
    return _GLIMPSE_HEAD_OP(joint, w, b, v)


def _glimpse_head_cuda(joint: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       v: torch.Tensor):
    """The op's CUDA implementation: check the operands, plan, launch, count."""
    if joint.ndim != 3 or w.ndim != 2 or v.ndim != 3:
        raise ValueError(f"expected joint [B, R, M], w [M, G], v [B, R, D], got "
                         f"{tuple(joint.shape)}, {tuple(w.shape)}, {tuple(v.shape)}")
    B, R, M = joint.shape
    G = w.shape[1]
    D = v.shape[2]
    dev, dt = joint.device, joint.dtype
    _build.require("joint", joint, dev, KERNEL_DTYPES, (B, R, M))
    _build.require("w", w, dev, dt, (M, G))
    _build.require("b", b, dev, dt, (G,))
    _build.require("v", v, dev, dt, (B, R, D))
    attended = torch.empty(B, G, D, dtype=dt, device=dev)
    logits = torch.empty(B, R, G, dtype=dt, device=dev)
    if B == 0:
        return attended, logits
    plan = glimpse_plan(B, R, M, G, D, vec=_vec(D, v, attended),
                        smem_limit=_build.smem_optin(dev.index or 0), elem=dt.itemsize)
    launch_glimpse_head(joint, w, b, v, attended, logits, plan)
    glimpse_head.launches += 1
    glimpse_head.design_launches[plan["copy"]] += 1
    return attended, logits


def _glimpse_head_fake(joint: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       v: torch.Tensor):
    B, R, _ = joint.shape
    G = w.shape[1]
    return joint.new_empty(B, G, v.shape[2]), joint.new_empty(B, R, G)


glimpse_head.launches = 0
glimpse_head.design_launches = dict.fromkeys(DESIGNS, 0)
_GLIMPSE_HEAD_OP = register("glimpse_head(Tensor joint, Tensor w, Tensor b, Tensor v) -> "
                            "(Tensor, Tensor)",
                            glimpse_head_reference, _glimpse_head_cuda, _glimpse_head_fake)
