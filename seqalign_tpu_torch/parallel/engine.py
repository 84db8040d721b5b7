"""Pair-batch sharding over a mesh of devices: the port's counterpart of
``seqalign_tpu/parallel/engine.py``.

Pairwise alignment is embarrassingly parallel over pairs, so a batch is
split over a 1-d :class:`Mesh` on its pairs axis, each shard a contiguous
block of pairs (``P(axis)`` in the JAX package), and no collective is
needed.  A shard runs the port's own single-device route on its device
and on a CUDA stream of its own: ``aligners._scores_auto`` across widths
for scores, the ``align_batch`` device path for alignments (the codes fill
across widths, then ``nw_walk``, or the harvest, ``sw_hits`` and
``sw_walk``).  The kernels are the single-device ones, launched once per
shard; results come back in pair order.  A device may repeat in a mesh:
its shards then share the card, each on its own stream (the CPU tests use
``Mesh([cpu] * 8)`` as the JAX tests use 8 virtual CPU devices).

The JAX package's rules stay: a batch is padded with filler pairs of
length 1 up to a multiple of the mesh (their results are dropped), NW
configs in the sentinel-wrap regime align on the int64 host path
(``engine.py:164-168``), and NW alignments come back as a list of
``Alignment``, SW as one hit stream per pair.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from .. import aligners
from ..ops import host_dp, kernels
from ..ops.pack import kernel_params
from ..scoring.config import ScoringConfig, from_reference


class Mesh:
    """A 1-d mesh: a tuple of torch devices and the name of its axis (the
    port's counterpart of a 1-d ``jax.sharding.Mesh``).  A device may
    repeat; each position is a shard of its own."""

    def __init__(self, devices: Sequence, axis: str = "pairs"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    def _key(self):
        return self.devices, self.axis

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"


def make_mesh(n_devices: Optional[int] = None, axis: str = "pairs", *,
              device: str = "cuda") -> Mesh:
    """The first ``n_devices`` CUDA devices (every one by default) as a
    mesh; raises ``RuntimeError`` when fewer exist: nothing falls back to
    the CPU.  ``device="cpu"`` asks for ``n_devices`` (default 1) positions
    on the CPU, where the kernels' plain versions run."""
    if device == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1), axis)
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else int(n_devices)
    if have == 0 or not 1 <= n <= have:
        raise RuntimeError(f"a mesh of {n_devices or 'all'} CUDA devices "
                           f"needs them; this machine has {have}")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


def _sc_key(sc: ScoringConfig) -> tuple:
    """A value key of a config: its scalars, flags and the digest of its
    swap and wildcard tables (every mutator changes one of them)."""
    h = hashlib.sha1()
    for t in (sc._swap_set, sc._swap_scores, sc._wild_set, sc._wild_scores):
        h.update(np.ascontiguousarray(t).tobytes())
    return (sc.match, sc.mismatch, sc.gap_open, sc.gap_extend,
            sc.min_penalty, sc.max_penalty, sc.no_start_gap_penalty,
            sc.no_end_gap_penalty, sc.no_gaps_in_a, sc.no_gaps_in_b,
            sc.no_mismatches, sc.case_sensitive, sc.use_match_mismatch,
            h.hexdigest())


# memoised per (what, config value, device or mesh, options); cleared when
# it passes 512 entries, so that a long run with many configs cannot grow it
_MEMO: dict = {}
# shard dispatches by entry, the counterpart of the JAX package's
# "scores2_sharded" / "dirs2_sharded" dispatch notes: one per shard a call
_DISPATCH = {"scores": 0, "align": 0, "score_fn": 0}


def _memo(key, build):
    hit = _MEMO.get(key)
    if hit is None:
        if len(_MEMO) > 512:
            _MEMO.clear()
        hit = _MEMO[key] = build()
    return hit


def shard_dispatch_counts() -> dict:
    """Shards dispatched so far by entry: ``scores`` (sharded_score_batch
    and the stream), ``align`` (sharded_align_batch), ``score_fn`` (the
    packed entry of :func:`make_sharded_score_fn`)."""
    return dict(_DISPATCH)


def _settled(dev: torch.device, obj):
    """``obj``, built on ``dev``'s current stream, once its copies to the
    card are done: the shards' streams read it without waiting on that
    stream."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    return obj


def _params(sc: ScoringConfig, dev: torch.device):
    return _memo(("params", _sc_key(sc), dev),
                 lambda: _settled(dev, kernel_params(sc, dev)))


def _aligner(sc: ScoringConfig, is_sw: bool, dev: torch.device):
    def build():
        if is_sw:  # the hit streams of a batch, no mask shared across pairs
            al = aligners.SmithWaterman(sc, ref_mask_compat=False,
                                        device=dev)
        else:
            al = aligners.NeedlemanWunsch(sc, device=dev)
        return _settled(dev, al)

    return _memo(("aligner", _sc_key(sc), is_sw, dev), build)


def _streams(mesh: Mesh):
    """A CUDA stream for each position of the mesh on a CUDA device, None
    for a CPU one."""
    return [torch.cuda.Stream(d) if d.type == "cuda" else None
            for d in mesh.devices]


@contextlib.contextmanager
def on_stream(dev: torch.device, stream):
    """Run the body on ``dev`` with ``stream`` as its current stream (a CPU
    device has none)."""
    if stream is None:
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


def _shards(n: int, nd: int):
    """The contiguous pair blocks of a batch of ``n`` pairs (a multiple of
    ``nd``) over ``nd`` positions."""
    per = n // nd
    return [(k * per, (k + 1) * per) for k in range(nd)]


def _fillers(seqs_a, seqs_b, nd: int):
    """The batch padded to a multiple of ``nd`` pairs with filler pairs of
    one letter each (the first letters of a pair of the batch, so that the
    config scores them), or empty ones when no pair has both sides."""
    rem = (-len(seqs_a)) % nd
    if not rem:
        return list(seqs_a), list(seqs_b)
    fa = fb = ""
    for a, b in zip(seqs_a, seqs_b):
        if a and b:
            fa, fb = a[:1], b[:1]
            break
    return list(seqs_a) + [fa] * rem, list(seqs_b) + [fb] * rem


def _score_dispatch(sc: ScoringConfig, seqs_a, seqs_b, *, is_sw: bool,
                    mesh: Mesh):
    """Pad and dispatch one sharded scores batch without fetching it:
    returns ([(scores, stream)] by shard, n).  The kernels' launches
    return at once, so a caller can pack and dispatch the next batch while
    this one fills (:func:`sharded_score_stream`)."""
    n = len(seqs_a)
    sa, sb = _fillers(seqs_a, seqs_b, mesh.size)
    parts = []
    for (lo, hi), dev, st in zip(_shards(len(sa), mesh.size), mesh.devices,
                                 _streams(mesh)):
        params = _params(sc, dev)
        with on_stream(dev, st):
            out = aligners._scores_auto(sc, params, sa[lo:hi],
                                        sb[lo:hi], is_sw=is_sw, defer=True,
                                        across=True)
        parts.append((out, st))
        _DISPATCH["scores"] += 1
    return parts, n


def _fetch(parts) -> np.ndarray:
    """The shards' scores on the host, in pair order."""
    out = []
    for v, st in parts:
        if isinstance(v, torch.Tensor):
            if st is not None:
                st.synchronize()
            v = v.cpu().numpy()
        out.append(np.asarray(v, np.int32))
    return np.concatenate(out) if out else np.zeros(0, np.int32)


def sharded_score_batch(sc: ScoringConfig, seqs_a, seqs_b, *, is_sw: bool,
                        mesh: Optional[Mesh] = None) -> np.ndarray:
    """Optimal scores of a batch (NW, or the SW best), the pairs sharded
    over ``mesh`` (by default every CUDA device): (n,) int32, equal to the
    single-device ``score_batch`` / ``best_score_batch``."""
    sc = from_reference(sc)
    parts, n = _score_dispatch(sc, seqs_a, seqs_b, is_sw=is_sw,
                               mesh=mesh if mesh is not None else make_mesh())
    return _fetch(parts)[:n]


def sharded_score_stream(sc: ScoringConfig, batches, *, is_sw: bool,
                         mesh: Optional[Mesh] = None, depth: int = 2):
    """Double-buffered streaming scorer: ``batches`` yields ``(seqs_a,
    seqs_b)``; yields one (n,) int32 array of scores per batch, in order.
    The packing and dispatch of the next ``depth - 1`` batches overlap the
    fill of the oldest one, which is fetched only once ``depth`` batches
    are in flight."""
    sc = from_reference(sc)
    mesh = mesh if mesh is not None else make_mesh()
    inflight = collections.deque()
    for sa, sb in batches:
        inflight.append(_score_dispatch(sc, sa, sb, is_sw=is_sw, mesh=mesh))
        if len(inflight) >= depth:
            parts, n = inflight.popleft()
            yield _fetch(parts)[:n]
    while inflight:
        parts, n = inflight.popleft()
        yield _fetch(parts)[:n]


def sharded_align_batch(sc: ScoringConfig, seqs_a, seqs_b, *, is_sw: bool,
                        mesh: Optional[Mesh] = None):
    """Full alignments with the pairs sharded over ``mesh``: NW returns a
    list of ``Alignment``, SW one hit stream per pair, equal to the
    single-device ``align_batch`` without a hint (each shard runs its
    device path)."""
    sc = from_reference(sc)
    if not is_sw and sc.sentinel_wrap_risk():
        # NW sentinel-overflow regime: int32 fills would wrap like the
        # reference's UB; the int64 host path instead (aligners._route)
        return [host_dp.nw_align(sc, a, b) for a, b in zip(seqs_a, seqs_b)]
    mesh = mesh if mesh is not None else make_mesh()
    n = len(seqs_a)
    if not n:
        return []
    sa, sb = _fillers(seqs_a, seqs_b, mesh.size)
    out = []
    for (lo, hi), dev, st in zip(_shards(len(sa), mesh.size), mesh.devices,
                                 _streams(mesh)):
        al = _aligner(sc, is_sw, dev)
        with on_stream(dev, st):
            if is_sw:
                out += al._align_batch_device(sa[lo:hi], sb[lo:hi],
                                              [1] * (hi - lo))
            else:
                out += al._align_batch_device(sa[lo:hi], sb[lo:hi])
        _DISPATCH["align"] += 1
    return out[:n]


def make_sharded_score_fn(sc: ScoringConfig, mesh: Mesh, *, is_sw: bool,
                          axis: str = "pairs"):
    """The packed-tensor entry: fn(ac, bc, na, nb, sub=None, im=None) ->
    (B,) int32 optimal scores of a packed batch (host arrays as
    ``pack.pack_batch`` makes them; ``sub``/``im`` the batch's compact
    table and is-match table under table scoring), B a multiple of the
    mesh, each shard one launch of the scores kernel at the batch's widths
    on its device.  Memoised on the config's value and the mesh."""
    if mesh.shape.get(axis) is None:
        raise ValueError(f"mesh {mesh} has no axis {axis!r}")
    sc = from_reference(sc)
    return _memo(("score_fn", _sc_key(sc), mesh, is_sw),
                 lambda: _build_score_fn(sc, mesh, is_sw))


def _build_score_fn(sc: ScoringConfig, mesh: Mesh, is_sw: bool):
    fill = kernels.sw_scores if is_sw else kernels.nw_scores

    def fn(ac, bc, na, nb, sub=None, im=None):
        B = len(na)
        if B % mesh.size:
            raise ValueError(f"{B} pairs do not divide over {mesh.size} "
                             f"devices")
        parts = []
        for (lo, hi), dev, st in zip(_shards(B, mesh.size), mesh.devices,
                                     _streams(mesh)):
            p = _params(sc, dev)
            with on_stream(dev, st):
                if sub is not None:
                    p = p._replace(sub=torch.from_numpy(np.asarray(
                        sub, np.int32)).to(dev), im=None if im is None else
                        torch.from_numpy(np.asarray(im, np.int32)).to(dev))
                args = [torch.from_numpy(np.ascontiguousarray(v[lo:hi])).to(
                    dev) for v in (ac, bc, na, nb)]
                out = fill(*args, p)
                parts.append((out if is_sw else out[0], st))
            _DISPATCH["score_fn"] += 1
        return _fetch(parts)

    return fn
