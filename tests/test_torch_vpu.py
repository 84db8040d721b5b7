"""The ALU probe's plain version (``ops.kernels.vpu_chain_plain``, which
``csrc/exp_vpu.cu`` is held to on the card) against the Pallas kernel body
of tools/exp_vpu.py:42-56, run in ``pl.pallas_call(..., interpret=True)``
on the CPU (``pltpu.roll`` interprets there: it is ``jnp.roll(w, 1, 1)``).
Four ops, int32 and int16, with inputs large enough that the sums wrap.
Exact equality."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from seqalign_tpu_torch.ops import kernels  # noqa: E402
from seqalign_tpu_torch.tools import exp_vpu  # noqa: E402

STEPS = 48
# inputs in [-HI / 4, HI): a sum of STEPS of them passes the type's range,
# so the chains wrap
HI = {"int32": 1 << 27, "int16": 4000}


def _jax_chain(x, S, op):
    """The kernel of tools/exp_vpu.py:42-56, its body as written there."""
    R, L = x.shape
    dt = x.dtype

    def kernel(x_ref, o_ref):
        v = x_ref[...]
        w = v
        for i in range(S):
            if op == "addmax":
                w = jnp.maximum(w + v, w)  # 2 elementwise ops
            elif op == "add":
                w = w + v
            elif op == "roll":
                w = pltpu.roll(w, 1, 1) + v
            elif op == "shift":
                w = jnp.concatenate(
                    [jnp.full((R, 1), 1, dt), w[:, : L - 1]], axis=1
                ) + v
        o_ref[...] = w

    return pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((R, L), dt),
                          interpret=True)(x)


@pytest.mark.parametrize("dtype", ["int32", "int16"])
@pytest.mark.parametrize("op", list(exp_vpu.OPS_PER))
def test_plain_chain_equals_pallas_kernel(op, dtype):
    rng = np.random.default_rng(len(op) + len(dtype))
    x = rng.integers(-HI[dtype] // 4, HI[dtype], (8, 64)).astype(dtype)
    want = np.asarray(_jax_chain(jnp.asarray(x), STEPS, op))
    got = kernels.vpu_chain_plain(torch.from_numpy(x), STEPS, op)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), want)
    # the sums wrapped: an int64 chain leaves the type's range
    wide = kernels.vpu_chain_plain(torch.from_numpy(x.astype(np.int64)),
                                   STEPS, op)
    assert not torch.equal(wide, got.long())
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        kernels.vpu_chain(torch.from_numpy(x), STEPS, op).numpy(), want)


def test_roll_and_shift_at_one_warp_width():
    """Rows of 32 int16 lanes: on the card 16 words, a sub-warp group of
    4 threads (``kernels.vpu_layout``)."""
    x = np.random.default_rng(5).integers(-1000, 1000, (4, 32)).astype(
        np.int16)
    for op in ("roll", "shift"):
        np.testing.assert_array_equal(
            kernels.vpu_chain_plain(torch.from_numpy(x), 40, op).numpy(),
            np.asarray(_jax_chain(jnp.asarray(x), 40, op)))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.vpu_chain(x.float(), 4, "add")
    with pytest.raises(ValueError):
        kernels.vpu_chain(x, 4, "mul")
    with pytest.raises(ValueError):
        kernels.vpu_chain(x, -1, "add")
    with pytest.raises(ValueError):
        kernels.vpu_chain(x[:, ::2], 4, "add")
    assert torch.equal(kernels.vpu_chain(x + 3, 0, "roll"), x + 3)


def test_probe_needs_a_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert exp_vpu.main(["--op", "roll", "--dtype", "int16"]) == 1
    assert "needs one GPU" in capsys.readouterr().err
    args = exp_vpu.parse(["--op", "shift", "--lanes", "32"])
    assert (args.op, args.lanes, args.dtype, args.steps, args.rows) == \
        ("shift", 32, "int32", 512, 256)
