"""The port's public surface against the JAX package's, on the CPU.

Every module of ``lambda_snark_tpu`` (``__main__`` aside) is held against
the module of the same path in ``lambda_snark_tpu_torch``:

- every public name the JAX module defines (a function or class whose
  ``__module__`` is that module), every public non-callable constant it
  holds, and, for a package, every public name it exports, must exist in
  the port's module; a constant that is an int, a string or bytes must
  have JAX's value;
- every public member of such a JAX class (what ``dir`` shows on the
  class) must exist on the port's class, as a member, a dataclass field or
  an attribute its methods set on ``self``;
- every parameter name of a public JAX function or method must be a
  parameter name of its counterpart.

Names that ``typing`` exports (``List``, ``Optional``, ``TYPE_CHECKING``)
and ``from __future__`` features are skipped by rule. Whatever has no
counterpart stands in ``NO_COUNTERPART`` with a one-line reason; a gap that
is not listed fails, and so does an entry that names no gap (a stale entry:
the port has gained the name, or the JAX package has lost it).
"""

from __future__ import annotations

import __future__

import ast
import dataclasses
import importlib
import inspect
import pkgutil
import textwrap
import types
import typing

import pytest

import lambda_snark_tpu
import lambda_snark_tpu_torch

_DIGITS = "JAX's base-2^16 digit planes; the port keeps one 64-bit word a residue"
_JIT = "a jax.jit wrapper; the port's function runs eagerly"
_CTX = "JAX's digit-plane modulus context; the port's word arithmetic takes q"
_PLANES = "a digit-plane array; the port's counterpart takes 64-bit words under its own name"
_TPU_PLAN = "JAX's TPU four-step plan; the port's plan is ops.ntt_large.NttLargePlan"
_MXU = "an MXU / VPU rate of the TPU roofline; the port's roofline counts bytes and operations"
_PALLAS = "a Pallas / MXU kernel file; its work is the port's CUDA kernels"
_INPUTS = ("the port takes the committed input groups as ``inputs`` (fri_open's form), "
           "which carry the planes, the forests and the group count")

#: Every JAX module, public name, member or parameter with no counterpart in
#: the port, each with its reason. Keyed by the JAX module's path under the
#: package; in each module, "" is the whole module, "name" a name,
#: "Class.member" a member, "function(param)" and "Class.method(param)" a
#: parameter.
NO_COUNTERPART = {
    "commit.lwe_jax": {"": "the JAX device commitment; the port's is commit/lwe_device"},
    "ops.goldilocks_np": {"": "numpy Goldilocks helpers; the port keeps its words in torch "
                              "(ops/modarith, ops/ntt)"},
    "ops.keccak_jax": {"": "the JAX Keccak; the port's is ops/keccak with kernel K"},
    "ops.keccak_pallas": {"": _PALLAS},
    "ops.limb": {"": "16-bit limb planes; the port keeps residues as 64-bit words"},
    "ops.ntt_jax": {"": "the JAX NTT; the port's is ops/ntt with kernel T"},
    "ops.ntt_mxu": {"": _PALLAS},
    "ops.ntt_mxu_q45": {"": _PALLAS},
    "ops.ntt_pallas": {"": _PALLAS},
    "ops.quotient_pallas": {"": _PALLAS},
    "ops.ring_mxu": {"": _PALLAS},
    "ops.ring_pallas": {"": _PALLAS},
    "ops.sampler_jax": {"": "the JAX sampler; the port's is ops/sampler"},
    "circuits.test_vectors": {
        "DEFAULT_TV_ROOT": "a machine-specific default path, dropped: pass root= or set "
                           "LAMBDA_SNARK_TV_ROOT",
    },
    "ops.modarith": {
        "BASE_BITS": _DIGITS,
        "MASK": _DIGITS,
        "add_mod_jit": _JIT,
        "sub_mod_jit": _JIT,
        "mul_mod_jit": _JIT,
        "cpu_fusion_barrier": "an XLA:CPU fusion barrier; eager torch ops need none",
        "mul_mod_const": "takes the constant as digits; the port's mul_mod(a, c, q) takes an "
                         "int c",
        "zeros_like_planes": _DIGITS,
        "add_mod(ctx)": _CTX,
        "sub_mod(ctx)": _CTX,
        "mul_mod(ctx)": _CTX,
        "reduce_mod(ctx)": _CTX,
    },
    "ops.ntt_large": {
        "FourStepPlan": _TPU_PLAN,
        "four_step_plan": _TPU_PLAN,
        "ntt_forward_large(fsp)": _TPU_PLAN,
        "ntt_inverse_large(fsp)": _TPU_PLAN,
    },
    "parallel.mesh": {
        "shard_planes": "a sharding spec of digit planes; the port's is shard_rows",
    },
    "parallel.ntt_sharded": {
        "ShardedNtt.coeff_to_device(planes)": _PLANES,
        "ShardedNtt.forward(x_sharded)": "a globally sharded plane array; the port's x is "
                                         "this rank's block of words",
        "ShardedNtt.inverse(f_sharded)": "a globally sharded plane array; the port's f is "
                                         "this rank's block of words",
    },
    "parallel.pipeline_sharded": {
        "ShardedProver.coeff_layout_to_flat(planes)": _PLANES,
        "ShardedProver.natural_to_eval_layout(evals_planes)": _PLANES,
    },
    "pipeline": {
        "field_plan_for": "JAX's digit-plane NTT plan; the port's tables come from "
                          "field_psi_for",
        "prove_stage_batch_jit": _JIT,
        "prove_stage_batch_zk_jit": _JIT,
        "quotient_batch_jit": _JIT,
        "ProvePlan.fused": "chose the Pallas quotient; the port always runs kernel Q",
        "ProvePlan.create(fused)": "chose the Pallas quotient; the port always runs kernel Q",
        "ProvePlan.qplan_mxu": "the MXU quotient plan; the port's is qplan (kernel Q)",
        "ProvePlan.rplan_mxu": "the MXU commitment plan; the port's is DeviceCommitContext "
                               "(kernel R)",
        "prove_stage_batch_zk(blind_planes)": _PLANES,
    },
    "proof.fri": {
        "DEVICE_HASH": "JAX's switch for its XLA Merkle hashing; the port's device route "
                       "hashes on kernel K",
        "lde_batch_device": "JAX's XLA LDE; the port's device route runs it on kernel T",
        "lde_batch_device_planes": "JAX's XLA LDE on digit planes; the port's device route "
                                   "runs it on kernel T",
    },
    "proof.fri_device": {
        "planes_from_u64": _DIGITS,
        "DevTranscript.absorb_chunks": "a per-operation method the chain no longer needs: "
                                       "kernel F absorbs inside fold_layer",
        "DevTranscript.squeeze": "a per-operation method the chain no longer needs: kernels F "
                                 "and S squeeze inside fold_layer and final_and_queries",
        "commit_planes_dev(planes4)": _PLANES,
        "commit_planes_dev_groups(planesK)": _PLANES,
        "deep_combine_device(input_planes)": _PLANES,
        "deep_combine_terms_device(cw_planes)": _PLANES,
        "sum_statements_device(g_planes)": _PLANES,
        "fri_prove_device(g_planes)": _PLANES,
        "fri_prove_device(input_planes)": _INPUTS,
        "fri_prove_device(input_forest)": _INPUTS,
        "fri_prove_device(n_groups)": _INPUTS,
        "fri_prove_device_chain(g_planes)": _PLANES,
        "fri_prove_device_chain(input_planes)": _INPUTS,
        "fri_prove_device_chain(input_forest)": _INPUTS,
        "fri_prove_device_chain(n_groups)": _INPUTS,
        "fri_chain_dispatch(g_planes)": _PLANES,
        "fri_chain_dispatch(input_planes)": _INPUTS,
        "fri_chain_dispatch(input_forest)": _INPUTS,
        "fri_chain_dispatch(n_groups)": _INPUTS,
        "fri_chain_finish(bundle_dev)": "the port's bundle is a device tensor of words, named "
                                        "bundle",
        "fri_chain_finish(cfg)": "JAX's tuple of sizes; the port's is a ChainLayout, named "
                                 "layout",
    },
    "proof.succinct_device": {
        "eval_device(polys_dev)": "JAX's (4 planes, S, 4, m) array; the port's polys is "
                                  "(S, 4, width) words",
        "quotient_lde_device(commit_ctx)": "split by design: quotient_lde_dispatch takes the "
                                           "commitment context as ctx",
        "quotient_lde_device(defer_pull)": "split by design: quotient_lde_dispatch always "
                                           "defers, finish_quotient_lde pulls",
        "finish_quotient_lde(deferred)": "split by design: the port's handle is named d",
    },
    "utils.timing": {
        "TPU_V5E": "names TPU hardware; the port's card is timing.H100",
        "roofline(mxu_int8_macs)": _MXU,
        "roofline(vpu_int32_ops)": _MXU,
        "ntt_roofline(digits)": _MXU,
        "trace(log_dir)": "JAX's is a TensorBoard directory; the port's trace(path) writes "
                          "one Chrome trace file",
    },
}


def _modules(pkg) -> dict:
    """The package's modules by path under it ("" for the package), all
    imported, ``__main__`` aside."""
    out = {"": pkg}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if info.name.rsplit(".", 1)[-1] != "__main__":
            out[info.name[len(pkg.__name__) + 1:]] = importlib.import_module(info.name)
    return out


JAX_MODULES = _modules(lambda_snark_tpu)
PORT_MODULES = _modules(lambda_snark_tpu_torch)


def _skipped(name: str, obj) -> bool:
    return (name.startswith("_") or isinstance(obj, (types.ModuleType, __future__._Feature))
            or getattr(typing, name, None) is obj)


def _self_attrs(cls) -> set:
    """The attributes the class's own methods (and its port bases') set on
    ``self``."""
    names = set()
    for klass in cls.__mro__:
        if not klass.__module__.startswith("lambda_snark_tpu_torch"):
            continue
        tree = ast.parse(textwrap.dedent(inspect.getsource(klass)))
        names |= {node.attr for node in ast.walk(tree)
                  if isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Store)
                  and isinstance(node.value, ast.Name) and node.value.id == "self"}
    return names


def _port_members(cls) -> set:
    fields = {f.name for f in dataclasses.fields(cls)} if dataclasses.is_dataclass(cls) else set()
    return set(dir(cls)) | fields | _self_attrs(cls)


def _routine(cls, name: str):
    """The function behind a class's member, or None for anything else."""
    for klass in cls.__mro__:
        if name in vars(klass):
            obj = vars(klass)[name]
            obj = obj.__func__ if isinstance(obj, (staticmethod, classmethod)) else obj
            return obj if inspect.isfunction(obj) else None
    return None


def _params(fn) -> list:
    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return []


def _param_gaps(label: str, theirs, ours) -> set:
    if ours is None or not callable(ours):
        return set()
    mine = set(_params(ours))
    return {f"{label}({p})" for p in _params(theirs) if p not in mine}


def _is_scalar(obj) -> bool:
    return isinstance(obj, (int, str, bytes)) and not isinstance(obj, bool)


def surface_gaps(path: str) -> set:
    """What JAX module ``path`` has and the port's module of that path
    lacks, in ``NO_COUNTERPART``'s notation."""
    theirs = JAX_MODULES[path]
    ours = PORT_MODULES.get(path)
    if ours is None:
        return {""}
    gaps = set()
    is_package = hasattr(theirs, "__path__")
    for name, obj in vars(theirs).items():
        if _skipped(name, obj):
            continue
        defined = getattr(obj, "__module__", None) == theirs.__name__
        if not (defined or is_package or not callable(obj)):
            continue
        if not hasattr(ours, name):
            gaps.add(name)
            continue
        mine = getattr(ours, name)
        if not callable(obj) and _is_scalar(obj) and mine != obj:
            gaps.add(f"{name} (value)")
        if not defined:
            continue
        if inspect.isclass(obj):
            members = _port_members(mine)
            for member in dir(obj):
                if member.startswith("_"):
                    continue
                if member not in members:
                    gaps.add(f"{name}.{member}")
                    continue
                fn = _routine(obj, member)
                if fn is not None and fn.__module__.startswith("lambda_snark_tpu."):
                    gaps |= _param_gaps(f"{name}.{member}", fn, _routine(mine, member))
        elif callable(obj):
            gaps |= _param_gaps(name, obj, mine)
    return gaps


@pytest.mark.parametrize("path", sorted(JAX_MODULES), ids=lambda p: p or "package")
def test_module_surface(path):
    """The module's gaps are exactly its listed entries."""
    gaps = surface_gaps(path)
    listed = set(NO_COUNTERPART.get(path, {}))
    assert not gaps - listed, f"no counterpart and no reason: {sorted(gaps - listed)}"
    assert not listed - gaps, f"stale entries: {sorted(listed - gaps)}"


def test_every_entry_names_a_jax_module_and_a_reason():
    assert set(NO_COUNTERPART) <= set(JAX_MODULES)
    for entries in NO_COUNTERPART.values():
        for reason in entries.values():
            assert reason.strip() and "\n" not in reason


@pytest.mark.parametrize("path, name, gap", [
    ("core.field", "vec_mod", "vec_mod"),
    ("proof.succinct", "GL_FAST_FRONTEND", "GL_FAST_FRONTEND"),
    ("utils.chacha", "chacha20_blocks_keys_np", "chacha20_blocks_keys_np"),
])
def test_a_removed_name_is_a_gap(monkeypatch, path, name, gap):
    monkeypatch.delattr(PORT_MODULES[path], name)
    assert gap in surface_gaps(path) - set(NO_COUNTERPART.get(path, {}))


@pytest.mark.parametrize("path, cls, member", [
    ("r1cs.sparse", "SparseMatrix", "from_dense"),
    ("r1cs.circuit", "CircuitBuilder", "num_vars"),
    ("proof.merkle", "MerkleTree", "from_u64_pairs"),
])
def test_a_removed_member_is_a_gap(monkeypatch, path, cls, member):
    monkeypatch.delattr(getattr(PORT_MODULES[path], cls), member)
    assert f"{cls}.{member}" in surface_gaps(path)


def test_a_removed_keyword_is_a_gap(monkeypatch):
    monkeypatch.setattr(PORT_MODULES["native_bridge"], "build", lambda: None)
    assert "build(force)" in surface_gaps("native_bridge")


def test_a_changed_constant_is_a_gap(monkeypatch):
    monkeypatch.setattr(PORT_MODULES["core.params"], "TOY_MODULUS", 12289 + 2)
    assert "TOY_MODULUS (value)" in surface_gaps("core.params")


def test_a_stale_entry_fails(monkeypatch):
    """An entry for a name the port has is stale, and so is one for a name
    the JAX package lacks."""
    entries = dict(NO_COUNTERPART.get("core.field", {}))
    entries["vec_mod"] = "stale"
    entries["no_such_name"] = "stale"
    monkeypatch.setitem(NO_COUNTERPART, "core.field", entries)
    with pytest.raises(AssertionError, match="stale entries"):
        test_module_surface("core.field")
