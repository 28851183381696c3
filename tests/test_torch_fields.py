"""Port vs JAX: packed registration fields (the plain version of kernel
K2), bit-exact in both modes against the XLA roll formulation and the
Pallas ``_rolling_kernel`` in interpret mode, on the random (37, 29, 23)
state of tests/test_registration_pallas.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpsense_tpu.kernels.fields_pallas import (
    precompute_fields_packed2_pallas, precompute_fields_packed_pallas)
from warpsense_tpu.map.local_map import LocalMapState as JState
from warpsense_tpu.ops import registration as jreg
from warpsense_tpu_torch.interop import state_from_numpy
from warpsense_tpu_torch.kernels.fields import fields_packed
from warpsense_tpu_torch.ops import registration as treg

TAU = 600


def _states(seed, size=(37, 29, 23), tau=TAU):
    rng = np.random.default_rng(seed)
    v = rng.integers(-tau, tau + 1, size, dtype=np.int64).astype(np.int16)
    w = (rng.random(size) < 0.7).astype(np.int16) * \
        rng.integers(1, 64, size).astype(np.int16)
    pos, off = [3, -2, 5], [7, 11, 2]
    j = JState(value=jnp.asarray(v), weight=jnp.asarray(w),
               pos=jnp.asarray(pos, jnp.int32),
               offset=jnp.asarray(off, jnp.int32))
    return j, state_from_numpy(v, w, pos, off, device="cpu")


@pytest.mark.parametrize("seed,tau", [(0, 600), (2, 300), (3, 32767)])
def test_packed_fields_bit_exact(seed, tau):
    j, t = _states(seed, tau=min(tau, 32767))
    got = treg.precompute_fields_packed(t, tau=tau).plane.numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jreg.precompute_fields_packed(j, tau=tau).plane))
    np.testing.assert_array_equal(
        got, np.asarray(precompute_fields_packed_pallas(j, tau=tau).plane))


@pytest.mark.parametrize("seed", [1, 4])
def test_exact_fields_bit_exact(seed):
    j, t = _states(seed)
    got = treg.precompute_fields_packed2(t)
    for ref in (jreg.precompute_fields_packed2(j),
                precompute_fields_packed2_pallas(j)):
        np.testing.assert_array_equal(got.plane_a.numpy(),
                                      np.asarray(ref.plane_a))
        np.testing.assert_array_equal(got.plane_b.numpy(),
                                      np.asarray(ref.plane_b))


def test_decode_roundtrip_matches_jax():
    j, t = _states(5)
    plane = treg.precompute_fields_packed(t, tau=TAU).plane
    vs, gs = treg.packed_shifts(TAU)
    assert (vs, gs) == jreg.packed_shifts(TAU)
    got = treg._decode_packed(plane, vs, gs)
    want = jreg._decode_packed(jnp.asarray(plane.numpy()), vs, gs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    x = torch.tensor([0x7FFF8000, -1, 0x00017FFF, -2 ** 31], dtype=torch.int32)
    np.testing.assert_array_equal(
        treg._unpack_lo(x).numpy(),
        np.asarray(jreg._unpack_lo(jnp.asarray(x.numpy()))))
    np.testing.assert_array_equal(
        treg._unpack_hi(x).numpy(),
        np.asarray(jreg._unpack_hi(jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("exact", [False, True])
def test_cpu_wrapper_runs_plain_version(exact):
    """On CPU tensors the K2 wrapper runs the plain version (no launch)."""
    _, t = _states(6)
    before = fields_packed.launches
    got = fields_packed(t, tau=TAU, exact=exact)
    assert fields_packed.launches == before
    want = (treg.precompute_fields_packed2(t) if exact
            else treg.precompute_fields_packed(t, tau=TAU))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
