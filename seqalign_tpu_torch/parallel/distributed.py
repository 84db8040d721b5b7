"""Multi-process execution over ``torch.distributed``: the port's
counterpart of ``seqalign_tpu/parallel/distributed.py``.

Pairwise alignment is embarrassingly parallel over pairs, so each process
reads a round-robin shard of the input pairs (``io.seqio.
read_pairs_sharded``), fills its pairs on its own device, and only the
results are exchanged: a ragged allgather of host vectors (int64 records
and uint8 string buffers, as the JAX package's process allgather), over
gloo, which serves on the CPU and beside the card alike, so that two
processes may share one card.  No collective runs inside a fill.

Entry points:

* ``init_from_env()``: call once per process.  Reads
  ``SEQALIGN_COORDINATOR`` (host:port), ``SEQALIGN_NUM_PROCS`` and
  ``SEQALIGN_PROC_ID`` (or explicit arguments) and brings up the process
  group (``init_process_group("gloo", init_method="tcp://host:port")``);
  returns False when no coordinator is set (one process).
* ``distributed_score_file()`` / ``distributed_align_file()``: every
  process scores or aligns its pair shard, on ``cuda:{rank % device
  count}`` unless given a device, and returns the complete, pair-ordered
  result, the same on every process.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..io import seqio
from ..ops.host_dp import Alignment
from ..ops.pack import kernel_params
from ..scoring.config import ScoringConfig, from_reference

# deferred score batches kept on the device at once; older ones are fetched
# (the JAX package's backpressure, distributed.py:121-131)
_MAX_DEFERRED = 4


def init_from_env(coordinator: Optional[str] = None,
                  num_processes: Optional[int] = None,
                  process_id: Optional[int] = None) -> bool:
    """Bring up the gloo process group from the arguments or the
    environment.  Returns True when multi-process mode is up, False when
    no coordinator is configured."""
    coordinator = coordinator or os.environ.get("SEQALIGN_COORDINATOR")
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ["SEQALIGN_NUM_PROCS"])
    if process_id is None:
        process_id = int(os.environ["SEQALIGN_PROC_ID"])
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def _world():
    """(rank, world size): (0, 1) without a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _device(device, pid: int) -> torch.device:
    """``device``, or the process's card ``cuda:{pid % count}``; raises
    without a card, as the aligners do."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "kernels' plain versions")
    return torch.device("cuda", pid % torch.cuda.device_count())


def _allgather(arr: np.ndarray) -> list:
    """Every process's host array (of one dtype and trailing shape, its
    first dimension ragged) as a list by rank."""
    import torch.distributed as dist

    n = dist.get_world_size()
    rows = torch.tensor([arr.shape[0]], dtype=torch.int64)
    counts = [torch.zeros_like(rows) for _ in range(n)]
    dist.all_gather(counts, rows)
    counts = [int(c) for c in counts]
    width = max(max(counts), 1)
    pad = np.zeros((width,) + arr.shape[1:], arr.dtype)
    pad[:arr.shape[0]] = arr
    t = torch.from_numpy(pad)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t)
    return [p.numpy()[:c] for p, c in zip(parts, counts)]


def _allgather_ragged(idx: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Every process's (global pair index, value) shard assembled into the
    full pair-ordered vector, the same on every process."""
    g_idx = _allgather(np.asarray(idx, np.int64))
    g_val = _allgather(np.asarray(vals, np.int64))
    flat = np.concatenate(g_idx)
    out = np.zeros(len(flat), np.int32)
    out[flat] = np.concatenate(g_val)
    return out


def distributed_score_file(sc: ScoringConfig, path1: str,
                           path2: Optional[str] = None, *, is_sw: bool,
                           batch: int = 256, device=None) -> np.ndarray:
    """Scores of every pair of the input file(s) across all processes:
    each process scores its round-robin shard in batches on its device,
    the newest ``_MAX_DEFERRED`` batches left on the device while the next
    ones are read and packed; the pair-ordered (n,) int32 vector comes back
    on every process.  One process (no ``init_from_env``) runs locally."""
    from ..aligners import _scores_auto

    sc = from_reference(sc)
    pid, nproc = _world()
    params = kernel_params(sc, _device(device, pid))
    idxs: list = []
    scores: list = []
    buf_i: list = []
    buf_a: list = []
    buf_b: list = []

    def flush():
        if not buf_i:
            return
        scores.append(_scores_auto(sc, params, buf_a, buf_b, is_sw=is_sw,
                                   defer=True))
        k = len(scores) - _MAX_DEFERRED
        if k > 0 and isinstance(scores[k - 1], torch.Tensor):
            scores[k - 1] = scores[k - 1].cpu().numpy()
        idxs.extend(buf_i)
        buf_i.clear()
        buf_a.clear()
        buf_b.clear()

    for idx, (_, seq_a), (_, seq_b) in seqio.read_pairs_sharded(
            path1, path2, pid, nproc):
        buf_i.append(idx)
        buf_a.append(seq_a)
        buf_b.append(seq_b)
        if len(buf_i) >= batch:
            flush()
    flush()
    local_idx = np.asarray(idxs, np.int64)
    local = (np.concatenate([s.cpu().numpy() if isinstance(s, torch.Tensor)
                             else np.asarray(s) for s in scores])
             if scores else np.zeros(0, np.int32))
    if nproc == 1:
        out = np.zeros(len(local_idx), np.int32)
        out[local_idx] = local
        return out
    return _allgather_ragged(local_idx, local)


def distributed_align_file(sc: ScoringConfig, path1: str,
                           path2: Optional[str] = None, *, is_sw: bool,
                           batch: int = 256,
                           min_score: Optional[int] = None,
                           max_hits: Optional[int] = None, device=None):
    """Alignments of every pair of the input file(s) across all processes:
    each process aligns its round-robin shard on its device, packs the
    records (score, positions, lengths, string offsets) and the strings,
    and the allgather assembles the complete pair-ordered result on every
    process.  NW: list[Alignment].  SW: list[list[Alignment]], each pair's
    hit stream best-first, cut at ``min_score`` (default 1: every hit) and
    at ``max_hits`` a pair.  One process runs locally."""
    from ..aligners import NeedlemanWunsch, SmithWaterman

    sc = from_reference(sc)
    pid, nproc = _world()
    dev = _device(device, pid)
    thr = 1 if min_score is None else int(min_score)
    al = (SmithWaterman(sc, ref_mask_compat=False, device=dev) if is_sw
          else NeedlemanWunsch(sc, device=dev))
    # (idx, hit_no, score, pos_a, pos_b, len_a, len_b, off, len ra, len rb)
    records: list = []
    parts: list = []
    buf_len = 0
    buf_i: list = []
    buf_a: list = []
    buf_b: list = []

    def emit(idx, hit_no, r):
        nonlocal buf_len
        pa, pb = r.result_a.encode(), r.result_b.encode()
        records.append((idx, hit_no, r.score, r.pos_a, r.pos_b, r.len_a,
                        r.len_b, buf_len, len(pa), len(pb)))
        parts.extend((pa, pb))
        buf_len += len(pa) + len(pb)

    def flush():
        if not buf_i:
            return
        if is_sw:
            iters = al.align_batch(buf_a, buf_b, min_scores=[thr] * len(buf_i))
            for idx, it in zip(buf_i, iters):
                for h_no, h in enumerate(it):
                    if h.score < thr or (max_hits is not None
                                         and h_no >= max_hits):
                        break
                    emit(idx, h_no, h)
        else:
            for idx, r in zip(buf_i, al.align_batch(buf_a, buf_b)):
                emit(idx, 0, r)
        buf_i.clear()
        buf_a.clear()
        buf_b.clear()

    n_total = 0
    for idx, (_, seq_a), (_, seq_b) in seqio.read_pairs_sharded(
            path1, path2, pid, nproc):
        n_total = max(n_total, idx + 1)
        buf_i.append(idx)
        buf_a.append(seq_a)
        buf_b.append(seq_b)
        if len(buf_i) >= batch:
            flush()
    flush()
    meta = np.asarray(records, np.int64).reshape(len(records), 10)
    buf = np.frombuffer(b"".join(parts), np.uint8)
    if nproc > 1:
        metas, bufs = _allgather(meta), _allgather(buf)
        # the pair count from every process: the shards are ragged
        n_total = int(np.concatenate(
            _allgather(np.array([n_total], np.int64))).max())
    else:
        metas, bufs = [meta], [buf]
    out: list = [[] for _ in range(n_total)] if is_sw else [None] * n_total
    staged = []
    for m, bb in zip(metas, bufs):
        for row in m:
            (idx, hit_no, score, pos_a, pos_b, lena, lenb, off, la_,
             lb_) = (int(v) for v in row)
            ra = bytes(bb[off:off + la_]).decode()
            rb = bytes(bb[off + la_:off + la_ + lb_]).decode()
            staged.append((idx, hit_no, Alignment(ra, rb, score, pos_a, pos_b,
                                                  lena, lenb)))
    for idx, _, aln in sorted(staged, key=lambda t: (t[0], t[1])):
        if is_sw:
            out[idx].append(aln)
        else:
            out[idx] = aln
    return out
