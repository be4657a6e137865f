"""The port's meshes and sharded NTT (``lambda_snark_tpu_torch.parallel``)
against the JAX package's, on the CPU.

The port's ranks are CPU processes over gloo (``spawn_local``), each
transform on kernel T's plain twin; the JAX reference runs JAX's
``ShardedNtt`` on a ring of 4 of ``tests/conftest.py``'s 8 virtual CPU
devices. At m = 1024 over both fields (R = C = 32) and on worlds of 2 and 4
ranks, the gathered raw eval layout, the natural order, the round trip and
the pointwise product must equal JAX's word for word (JAX's own test of the
same transform is ``tests/test_sharded.py``). The rank functions are in
``tests/torch_parallel_ranks.py``, which imports no JAX.
"""

import numpy as np
import pytest
import torch

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.core import field
from lambda_snark_tpu_torch.ops import modarith
from lambda_snark_tpu_torch.parallel import make_mesh, ring_mesh
from lambda_snark_tpu_torch.parallel.multihost import ScalingPoint, measure_scaling, spawn_local

import torch_parallel_ranks as ranks

M = 1024
FIELDS = {
    "q45": (port.NTT_FRIENDLY_MODULUS, port.ROOTS_OF_UNITY_45BIT[M]),
    "goldilocks": (port.NTT_MODULUS, field.mod_pow(port.NTT_PRIMITIVE_ROOT, (1 << 32) // M,
                                                   port.NTT_MODULUS)),
}
WORLDS = (2, 4)


def _inputs(q: int):
    rng = np.random.default_rng(q % 1000)
    return (rng.integers(0, q, size=M, dtype=np.uint64),
            rng.integers(0, q, size=M, dtype=np.uint64))


@pytest.fixture(scope="module")
def port_runs():
    """Rank 0's results on each world, both fields in one spawn."""
    cases = [(q, M, omega, *_inputs(q)) for q, omega in FIELDS.values()]
    return {n: spawn_local(n, ranks.ntt_rank, (cases,), device="cpu") for n in WORLDS}


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's ShardedNtt on a ring of 4 devices: raw layout, natural order,
    round trip and pointwise product, as uint64 arrays."""
    import jax

    from lambda_snark_tpu.ops.limb import from_limbs, modulus_ctx, to_limbs
    from lambda_snark_tpu.parallel.mesh import ring_mesh as jax_ring_mesh
    from lambda_snark_tpu.parallel.ntt_sharded import ShardedNtt as JaxShardedNtt

    assert len(jax.devices()) >= 4
    out = {}
    values = lambda planes: np.array([int(v) for v in from_limbs(np.asarray(planes)).reshape(-1)],
                                     dtype=np.uint64)
    for name, (q, omega) in FIELDS.items():
        sh = JaxShardedNtt(M, q, omega, jax_ring_mesh(4))
        d = modulus_ctx(q).d
        a, b = (to_limbs(np.array([int(v) for v in x], dtype=object), d) for x in _inputs(q))
        fa, fb = sh.forward(sh.coeff_to_device(a)), sh.forward(sh.coeff_to_device(b))
        out[name] = dict(
            raw=values(fa).reshape(sh.fsp.r, sh.fsp.c), r=sh.fsp.r, c=sh.fsp.c,
            natural=values(sh.eval_layout_to_natural(fa)),
            back=values(sh.coeff_from_device(sh.inverse(fa))),
            product=values(sh.eval_layout_to_natural(sh.pointwise_mul(fa, fb))))
    return out


def _u64(t: torch.Tensor) -> np.ndarray:
    return modarith.to_u64(t)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", FIELDS)
def test_raw_eval_layout_equals_jax(port_runs, jax_runs, name, world):
    got = port_runs[world][0][FIELDS[name][0]]
    want = jax_runs[name]
    assert (got["r"], got["c"]) == (want["r"], want["c"]) == (32, 32)
    assert np.array_equal(_u64(got["raw"]), want["raw"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", FIELDS)
def test_natural_order_equals_jax_and_the_host(port_runs, jax_runs, name, world):
    q, omega = FIELDS[name]
    got = _u64(port_runs[world][0][q]["natural"])
    assert np.array_equal(got, jax_runs[name]["natural"])
    # the textbook DFT at a few points
    a = [int(v) for v in _inputs(q)[0]]
    for k in (0, 1, 511, 1023):
        x = field.mod_pow(omega, k, q)
        assert int(got[k]) == sum(c * pow(x, t, q) for t, c in enumerate(a)) % q


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", FIELDS)
def test_round_trip(port_runs, jax_runs, name, world):
    q = FIELDS[name][0]
    run = port_runs[world][0][q]
    assert np.array_equal(_u64(run["back"]), _inputs(q)[0])
    assert np.array_equal(_u64(run["back"]), jax_runs[name]["back"])
    # natural order -> eval layout -> natural order is the identity
    assert torch.equal(run["layout"], run["natural"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", FIELDS)
def test_pointwise_mul_equals_jax(port_runs, jax_runs, name, world):
    q = FIELDS[name][0]
    run = port_runs[world][0][q]
    assert np.array_equal(_u64(run["product"]), jax_runs[name]["product"])


@pytest.mark.parametrize("world", WORLDS)
def test_twiddle_rows_per_rank(port_runs, world):
    for q, _omega in FIELDS.values():
        assert tuple(port_runs[world][0][q]["tw"]) == (32 // world, 32)


def test_meshes_span_the_world(port_runs):
    run = port_runs[4][0]
    assert run["ring"] == (4,) and run["ring_names"] == ("sp",)
    assert run["grid"] == (2, 2)
    assert run["error [4, 2]"] == "need 8 ranks, have 4"
    assert run["error [1, 2]"] == "a mesh of 2 ranks must span the world of 4"
    assert port_runs[2][0]["ring"] == (2,)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_import_no_jax(port_runs, world):
    assert all(r["foreign"] == [] for r in port_runs[world])


@pytest.mark.parametrize("fn", [lambda: make_mesh([1, 1], device="cpu"),
                                lambda: ring_mesh(device="cpu")])
def test_a_mesh_needs_a_process_group(fn):
    with pytest.raises(RuntimeError, match="no process group"):
        fn()


def test_measure_scaling_on_a_trivial_step():
    calls = []

    def factory(n):
        work = torch.arange(1000 * n)

        def step():
            calls.append(n)
            return int(work.sum())
        return step

    points = measure_scaling(factory, [1, 2, 4], iters=3)
    assert [p.n_devices for p in points] == [1, 2, 4]
    assert all(isinstance(p, ScalingPoint) and p.per_step_s > 0 for p in points)
    assert points[0].efficiency == 1.0
    assert calls == [1] * 4 + [2] * 4 + [4] * 4  # a warm-up, then ``iters`` steps
