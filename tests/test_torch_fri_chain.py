"""The port's single-dispatch FRI chain (``proof.fri_device``,
``DEVICE_TRANSCRIPT``) against the JAX package, on the CPU, where kernels S
(the transcript sponge) and F (the fold) run as their plain twins.

- (a) the chain's proofs against the JAX chain (JAX's ``fri_prove_device``
  with its ``DEVICE_TRANSCRIPT`` on) on the cases of
  ``tests/test_fri_device.py`` (``FriParams(2, 4, 4)``, S in {1, 3}, n0 in
  {64, 128}) and a kind-8-shaped case (one statement, one group of 4 S'
  oracles in S' trees);
- (b) the chain against the port's per-layer route (the switch off);
- (c) the sponge twin against hashlib (one and several rate blocks, the
  0x86 pad, ``fri-final`` at final_len 4 and 64), the squeeze twins
  against ``FriTranscript``, the challenge reduction on words >= p;
- (d) a final polynomial over its bound raises in ``fri_chain_finish``;
- (e) kinds 7 (batch and single) and 8 through the chain against the JAX
  package's bytes, and the three-phase pipelined prover (S = 5, chunks of
  2) against JAX's unchunked bytes (its ``_prove_pipelined`` bytes are
  held in ``tests/test_torch_succinct_stream.py``), with its gate.

The JAX package is imported inside fixtures, so the ``cuda`` test at the
end runs on a card machine without JAX:
``python -m pytest tests/test_torch_fri_chain.py -m cuda --noconftest -q``.
"""

import hashlib
import importlib
import struct
import types

import numpy as np
import pytest
import torch

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.core.errors import DomainError
from lambda_snark_tpu_torch.ops import fri_fold, keccak, modarith
from lambda_snark_tpu_torch.proof import fri_device
from lambda_snark_tpu_torch.proof import succinct_batch as sb
from lambda_snark_tpu_torch.proof.fri import FriParams, FriTranscript, coset_offset, root_of_order

P = port.NTT_MODULUS
FAST = FriParams(log_blowup=2, num_queries=4, final_len=4)
KIND7 = FriParams(log_blowup=3, num_queries=8)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces, imported here (not on a card machine)."""
    J = importlib.import_module("lambda_snark_tpu")
    jfd = importlib.import_module("lambda_snark_tpu.proof.fri_device")
    jfri = importlib.import_module("lambda_snark_tpu.proof.fri")
    jsb = importlib.import_module("lambda_snark_tpu.proof.succinct_batch")
    jagg = importlib.import_module("lambda_snark_tpu.proof.aggregate")
    tfd = importlib.import_module("test_fri_device")
    ts = importlib.import_module("test_succinct")
    ctx = J.setup(J.Params(J.SecurityLevel.BITS128, J.Profile.ring_b(64, 1, P, 3.19)))
    return types.SimpleNamespace(J=J, fd=jfd, fri=jfri, sb=jsb, agg=jagg, tfd=tfd, ts=ts,
                                 ctx=ctx)


def _transcripts(seeds):
    trs = []
    for seed in seeds:
        tr = FriTranscript()
        tr.absorb(b"case", seed)
        trs.append(tr)
    return trs


def _port_proofs(cw, g, trees, seeds, params=FAST):
    """The port's proofs of g (S, n0) over the input group cw (S, K, n0),
    whose S statements' oracles sit in ``trees`` trees each."""
    s, k, n0 = cw.shape
    vals = modarith.to_words(cw)
    forest = fri_device.commit_planes_dev_groups(vals.reshape(s * trees, k // trees, n0))
    return fri_device.fri_prove_device(modarith.to_words(g), [(vals, forest)],
                                       coset_offset(P), root_of_order(P, n0), P, params,
                                       _transcripts(seeds))


def _jax_proofs(jx, cw, g, trees, seeds):
    """The JAX package's device FRI of the same case (its chain)."""
    s, k, n0 = cw.shape
    planes = jx.fd.planes_from_u64(cw.reshape(s * trees, k // trees, n0))
    forest = jx.fd.commit_planes_dev_groups(planes)
    trs = []
    for seed in seeds:
        tr = jx.fri.FriTranscript()
        tr.absorb(b"case", seed)
        trs.append(tr)
    return jx.fd.fri_prove_device(jx.fd.planes_from_u64(g), planes.reshape(4, s, k, n0), forest,
                                  coset_offset(P), root_of_order(P, n0), P,
                                  jx.fri.FriParams(2, 4, 4), trs, n_groups=trees)


def _kind8_case(jx, statements: int, n0: int):
    """One FRI statement over 4 S' oracles in S' trees, g their sum."""
    _q, _off, _om, cw, _g = jx.tfd._proof_case(13, statements, n0)
    cw = cw.reshape(1, 4 * statements, n0)
    g = modarith.to_u64(fri_device.sum_statements_device(modarith.to_words(cw[0])))
    return cw, g


CASES = [(1, 64), (3, 64), (1, 128), (3, 128)]


def _bytes(proofs):
    return [p.to_bytes() for p in proofs]


# --- (a) and (b): the chain against the JAX chain and the per-layer route --------


@pytest.mark.parametrize("s,n0", CASES)
def test_chain_equals_jax_chain(jx, s, n0):
    assert jx.fd.DEVICE_TRANSCRIPT and fri_device.DEVICE_TRANSCRIPT
    _q, _off, _om, cw, g = jx.tfd._proof_case(7, s, n0)
    seeds = [bytes([i]) * 4 for i in range(s)]
    mine = _port_proofs(cw, g, 1, seeds)
    assert _bytes(mine) == _bytes(_jax_proofs(jx, cw, g, 1, seeds))


def test_kind8_shaped_chain_equals_jax_chain(jx):
    cw, g = _kind8_case(jx, 3, 64)
    assert _bytes(_port_proofs(cw, g, 3, [b"agg"])) == _bytes(_jax_proofs(jx, cw, g, 3, [b"agg"]))


@pytest.mark.parametrize("s,n0", CASES + [(1, 256)])
def test_chain_equals_per_layer_route(jx, monkeypatch, s, n0):
    _q, _off, _om, cw, g = jx.tfd._proof_case(11, s, n0)
    seeds = [bytes([7 + i]) * 3 for i in range(s)]
    chain = _port_proofs(cw, g, 1, seeds)
    monkeypatch.setattr(fri_device, "DEVICE_TRANSCRIPT", False)
    assert _bytes(_port_proofs(cw, g, 1, seeds)) == _bytes(chain)


def test_kind8_shaped_chain_equals_per_layer_route(jx, monkeypatch):
    cw, g = _kind8_case(jx, 4, 128)
    chain = _port_proofs(cw, g, 4, [b"agg"])
    monkeypatch.setattr(fri_device, "DEVICE_TRANSCRIPT", False)
    assert _bytes(_port_proofs(cw, g, 4, [b"agg"])) == _bytes(chain)


def test_chain_opens_unequal_groups_as_the_per_layer_route(jx):
    """Two input groups of 5 and 2 oracles (kind 9's shape): both routes
    give the same bytes."""
    _q, off, om, cw, g = jx.tfd._proof_case(17, 2, 64, k=7)
    pre, post = modarith.to_words(cw[:, :5]), modarith.to_words(cw[:, 5:])
    inputs = [(pre, fri_device.commit_planes_dev_groups(pre)),
              (post, fri_device.commit_planes_dev_groups(post))]
    seeds = [b"u0", b"u1"]
    chain = fri_device.fri_prove_device_chain(modarith.to_words(g), inputs, off, om, P, FAST,
                                              _transcripts(seeds))
    committed, finals, idx = fri_device.fri_commit_layers(modarith.to_words(g), off, om, P,
                                                          FAST, _transcripts(seeds))
    assert _bytes(chain) == _bytes(fri_device.fri_open(inputs, committed, finals, idx))


def test_chain_leaves_the_host_transcripts_as_they_were(jx):
    _q, _off, _om, cw, g = jx.tfd._proof_case(7, 2, 64)
    trs = _transcripts([b"a", b"b"])
    before = [(tr._state, tr._counter) for tr in trs]
    vals = modarith.to_words(cw)
    fri_device.fri_prove_device_chain(modarith.to_words(g),
                                      [(vals, fri_device.commit_planes_dev_groups(vals))],
                                      coset_offset(P), root_of_order(P, 64), P, FAST, trs)
    assert [(tr._state, tr._counter) for tr in trs] == before


def test_transcripts_out_of_lockstep_are_refused():
    trs = _transcripts([b"a", b"b"])
    trs[1].challenge_field(P, b"x")
    with pytest.raises(ValueError, match="lockstep"):
        fri_device.DevTranscript.upload(trs, "cpu")


# --- (c): kernel S's twin against hashlib and FriTranscript ------------------------


def _states(rng, s: int) -> torch.Tensor:
    return modarith.to_words(rng.integers(0, 1 << 64, size=(s, 4), dtype=np.uint64,
                                          endpoint=False))


@pytest.mark.parametrize("label,words,head", [
    (b"fri-layer-root", 4, None),  # 78 bytes: one block
    (b"fri-final", 4, 4),  # final_len 4: 81 bytes
    (b"fri-final", 64, 64),  # final_len 64: 561 bytes, five blocks
    (b"fri-final", 11, 11),  # 137 bytes: the message crosses into a second block
    (b"x" * 15, 10, 7),  # 135 bytes: 0x06 and 0x80 fold to 0x86
    (b"y" * 16, 10, 3),  # 136 bytes: a block of padding alone
    (b"", 0, None),  # the state alone
])
def test_absorb_twin_equals_hashlib(label, words, head):
    rng = np.random.default_rng(len(label) + words)
    state = _states(rng, 3)
    payload = rng.integers(0, 1 << 64, size=(3, words), dtype=np.uint64, endpoint=False)
    got = modarith.to_u64(keccak.transcript_absorb(
        state, label, modarith.to_words(payload) if words else None, head))
    for i, st in enumerate(modarith.to_u64(state)):
        msg = st.tobytes() + label + (b"" if head is None else struct.pack("<Q", head))
        msg += payload[i].tobytes()
        assert got[i].tobytes() == hashlib.sha3_256(msg).digest()


def test_absorb_twin_equals_fri_transcript():
    trs = _transcripts([b"p", b"q"])
    state = fri_device.DevTranscript.upload(trs, "cpu").state
    rng = np.random.default_rng(4)
    roots = rng.integers(0, 1 << 64, size=(2, 4), dtype=np.uint64, endpoint=False)
    fins = rng.integers(0, P, size=(2, 4), dtype=np.uint64)
    state = keccak.transcript_absorb(state, b"fri-layer-root", modarith.to_words(roots))
    state = keccak.transcript_absorb(state, b"fri-final", modarith.to_words(fins), 4)
    for i, tr in enumerate(trs):
        tr.absorb(b"fri-layer-root", roots[i].tobytes())
        tr.absorb_words(b"fri-final", [int(v) for v in fins[i]])
        assert modarith.to_u64(state)[i].tobytes() == tr._state


def test_squeeze_field_twin_equals_challenge_field():
    trs = _transcripts([b"f0", b"f1", b"f2"])
    state = fri_device.DevTranscript.upload(trs, "cpu").state
    for counter in range(1, 9):
        state, cs = keccak.transcript_squeeze_field(state, b"fri-fold", counter)
        assert modarith.to_u64(cs).tolist() == [tr.challenge_field(P, b"fri-fold") for tr in trs]
    assert trs[0]._counter == 8
    assert [s.tobytes() for s in modarith.to_u64(state)] == [tr._state for tr in trs]


@pytest.mark.parametrize("bound,count", [(1 << 5, 30), (1 << 15, 30), (1, 3)])
def test_squeeze_indices_twin_equals_challenge_indices(bound, count):
    trs = _transcripts([b"i0", b"i1"])
    for tr in trs:
        tr.challenge_field(P, b"fri-fold")
    state = fri_device.DevTranscript.upload(trs, "cpu").state
    state, idx = keccak.transcript_squeeze_indices(state, b"fri-query", 2, count, bound)
    assert idx.tolist() == [tr.challenge_indices(bound, count, b"fri-query") for tr in trs]
    assert trs[0]._counter == 1 + count
    assert [s.tobytes() for s in modarith.to_u64(state)] == [tr._state for tr in trs]


@pytest.mark.parametrize("with_root", [False, True])
def test_fold_layer_equals_fri_transcript(with_root):
    trs = _transcripts([b"l0", b"l1", b"l2"])
    for tr in trs:
        tr.challenge_field(P, b"fri-fold")
    dev = fri_device.DevTranscript.upload(trs, "cpu")
    rng = np.random.default_rng(5)
    cur = modarith.to_words(rng.integers(0, P, size=(3, 16), dtype=np.uint64))
    inv_x = modarith.to_words(rng.integers(0, P, size=8, dtype=np.uint64))
    roots = rng.integers(0, 1 << 64, size=(3, 4), dtype=np.uint64, endpoint=False)
    out = dev.fold_layer(cur, inv_x, modarith.to_words(roots) if with_root else None)
    cs = []
    for i, tr in enumerate(trs):
        if with_root:
            tr.absorb(b"fri-layer-root", roots[i].tobytes())
        cs.append(tr.challenge_field(P, b"fri-fold"))
    assert torch.equal(out, fri_fold.fold_plain(cur, inv_x, modarith.to_words(cs)))
    assert dev.counter == trs[0]._counter == 2
    assert [s.tobytes() for s in modarith.to_u64(dev.state)] == [tr._state for tr in trs]


@pytest.mark.parametrize("bound,count", [(1 << 5, 30), (1, 3)])
def test_final_and_queries_equals_fri_transcript(bound, count):
    trs = _transcripts([b"t0", b"t1"])
    for tr in trs:
        tr.challenge_field(P, b"fri-fold")
    dev = fri_device.DevTranscript.upload(trs, "cpu")
    fins = np.random.default_rng(6).integers(0, P, size=(2, 4), dtype=np.uint64)
    idx = dev.final_and_queries(modarith.to_words(fins), bound, count)
    for tr, fin in zip(trs, fins):
        tr.absorb_words(b"fri-final", [int(v) for v in fin])
    assert idx.tolist() == [tr.challenge_indices(bound, count, b"fri-query") for tr in trs]
    assert dev.counter == trs[0]._counter == 1 + count
    assert [s.tobytes() for s in modarith.to_u64(dev.state)] == [tr._state for tr in trs]


def test_challenge_reduction_on_words_at_or_above_p():
    words = [P, P + 1, (1 << 64) - 1, P - 1, 0, 1 << 63, (1 << 63) - 1, P + 12345]
    got = modarith.to_u64(keccak.challenge_words(modarith.to_words(words))).tolist()
    assert got == [w % P for w in words]


def test_sponge_refuses_a_bad_bound_or_a_long_label():
    with pytest.raises(ValueError):
        keccak.transcript_squeeze_indices(_states(np.random.default_rng(1), 1), b"q", 1, 4, 24)
    with pytest.raises(ValueError):
        keccak.transcript_absorb(_states(np.random.default_rng(1), 1), b"z" * 17)


# --- (d): the degree flag ------------------------------------------------------------


def test_final_polynomial_over_its_bound_raises_in_finish(monkeypatch):
    rng = np.random.default_rng(9)
    n0 = 64
    g = modarith.to_words(rng.integers(0, P, size=(2, n0), dtype=np.uint64))  # full degree
    cw = modarith.to_words(rng.integers(0, P, size=(2, 4, n0), dtype=np.uint64))
    inputs = [(cw, fri_device.commit_planes_dev_groups(cw))]
    args = (g, inputs, coset_offset(P), root_of_order(P, n0), P, FAST)
    bundle, layout = fri_device.fri_chain_dispatch(*args, _transcripts([b"d0", b"d1"]))
    with pytest.raises(DomainError, match="degree bound"):
        fri_device.fri_chain_finish(bundle, layout)
    monkeypatch.setattr(fri_device, "DEVICE_TRANSCRIPT", False)
    with pytest.raises(DomainError, match="degree bound"):
        fri_device.fri_prove_device(*args, _transcripts([b"d0", b"d1"]))


def test_fold_twin_folds_a_line_to_its_value():
    """A degree-1 codeword a + b x folds to the constant a + c b."""
    n, a, b, c = 16, 5, 7, 11
    off, om = coset_offset(P), root_of_order(P, n)
    xs = [off * pow(om, i, P) % P for i in range(n)]
    cur = modarith.to_words([[(a + b * x) % P for x in xs]])
    inv_x = modarith.to_words([pow(x, P - 2, P) for x in xs[: n // 2]])
    out = fri_fold.fold(cur, inv_x, modarith.to_words([c]))
    assert modarith.to_u64(out).tolist() == [[(a + c * b) % P] * (n // 2)]


# --- (e): the slice as a whole ------------------------------------------------------


@pytest.fixture(scope="module")
def kind7(jx):
    ours = port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                       port.Profile.ring_b(n=64, k=1, q=P, sigma=3.19)))
    ws = [jx.ts.mult_witness(16, P, seed=60 + i) for i in range(5)]
    return types.SimpleNamespace(ctx=ours, jr=jx.ts.mult_circuit(16, P),
                                 pr=port.multiplication_gates_circuit(16, P), ws=ws)


def _count_calls(monkeypatch, module, name, log):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        log.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


def test_batch_through_the_chain_equals_jax(jx, kind7, monkeypatch):
    calls = []
    _count_calls(monkeypatch, fri_device, "fri_chain_dispatch", calls)
    seeds = [31, 32, 33]
    mine = port.prove_r1cs_succinct_batch(kind7.pr, kind7.ws[:3], kind7.ctx, seeds,
                                          fri_params=KIND7, device="cpu")
    theirs = jx.sb.prove_r1cs_succinct_batch(kind7.jr, kind7.ws[:3], jx.ctx, seeds,
                                             fri_params=jx.fri.FriParams(3, 8),
                                             device_lde=False)
    assert calls == ["fri_chain_dispatch"]
    assert _bytes(mine) == _bytes(theirs)
    monkeypatch.setattr(fri_device, "DEVICE_TRANSCRIPT", False)
    off = port.prove_r1cs_succinct_batch(kind7.pr, kind7.ws[:3], kind7.ctx, seeds,
                                         fri_params=KIND7, device="cpu")
    assert calls == ["fri_chain_dispatch"] and _bytes(off) == _bytes(theirs)


def test_single_through_the_chain_equals_jax(jx, kind7, monkeypatch):
    calls = []
    _count_calls(monkeypatch, fri_device, "fri_chain_dispatch", calls)
    mine = port.prove_r1cs_succinct(kind7.pr, kind7.ws[0], kind7.ctx, 41, fri_params=KIND7,
                                    device="cpu")
    theirs = jx.J.prove_r1cs_succinct(kind7.jr, kind7.ws[0], jx.ctx, 41,
                                      fri_params=jx.fri.FriParams(3, 8))
    assert calls == ["fri_chain_dispatch"]
    assert mine.to_bytes() == theirs.to_bytes()


def test_aggregate_through_the_chain_equals_jax(jx, kind7, monkeypatch):
    calls = []
    _count_calls(monkeypatch, fri_device, "fri_chain_dispatch", calls)
    seeds = [51, 52, 53]
    mine = port.prove_r1cs_succinct_aggregate(kind7.pr, kind7.ws[:3], kind7.ctx, seeds,
                                              fri_params=KIND7, device="cpu")
    theirs = jx.agg.prove_r1cs_succinct_aggregate(kind7.jr, kind7.ws[:3], jx.ctx, seeds,
                                                  fri_params=jx.fri.FriParams(3, 8),
                                                  device_lde=False)
    assert calls == ["fri_chain_dispatch"]
    assert mine.to_bytes() == theirs.to_bytes()
    assert port.verify_r1cs_succinct_aggregate(mine, [[1]] * 3, kind7.pr, min_params=KIND7)


def test_pipelined_runs_three_phases_and_equals_jax(jx, kind7, monkeypatch):
    """S = 5 in chunks of 2: every front end enqueued, then every chain,
    then every bundle pulled; the bytes are JAX's unchunked prover's."""
    calls = []
    _count_calls(monkeypatch, sb, "quotient_lde_dispatch", calls)
    _count_calls(monkeypatch, fri_device, "fri_chain_dispatch", calls)
    _count_calls(monkeypatch, fri_device, "fri_chain_finish", calls)
    seeds = [61, 62, 63, 64, 65]
    mine = port.prove_r1cs_succinct_batch(kind7.pr, kind7.ws, kind7.ctx, seeds,
                                          fri_params=KIND7, pipeline_chunk=2, device="cpu")
    assert calls == (["quotient_lde_dispatch"] * 3 + ["fri_chain_dispatch"] * 3
                     + ["fri_chain_finish"] * 3)
    theirs = jx.sb.prove_r1cs_succinct_batch(kind7.jr, kind7.ws, jx.ctx, seeds,
                                             fri_params=jx.fri.FriParams(3, 8),
                                             device_lde=False)
    assert _bytes(mine) == _bytes(theirs)


def test_pipelined_gate_needs_the_device_transcript(kind7, monkeypatch):
    """With the switch off the chunked prover proves unchunked, as JAX's
    gate does."""
    seeds = [71, 72, 73]
    want = port.prove_r1cs_succinct_batch(kind7.pr, kind7.ws[:3], kind7.ctx, seeds,
                                          fri_params=KIND7, device="cpu")
    calls = []
    _count_calls(monkeypatch, sb, "quotient_lde_dispatch", calls)
    monkeypatch.setattr(fri_device, "DEVICE_TRANSCRIPT", False)
    got = port.prove_r1cs_succinct_batch(kind7.pr, kind7.ws[:3], kind7.ctx, seeds,
                                         fri_params=KIND7, pipeline_chunk=2, device="cpu")
    assert calls == ["quotient_lde_dispatch"] and _bytes(got) == _bytes(want)


# --- on the card ------------------------------------------------------------------------


@pytest.mark.cuda
def test_kernels_s_and_f_match_their_twins_on_card():
    """Kernel S (every entry, S = 1, 16, 32, 128, the chain's tail among
    them) and kernel F (the fold with given challenges at kind 9's and the
    chain's shapes, and its chain entry with and without a root at the
    chain's shapes) against their twins on the card (run with ``python -m
    pytest tests/test_torch_fri_chain.py -m cuda --noconftest -q``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(21)
    dev = torch.device("cuda")
    for s in (1, 16, 32, 128):
        state = _states(rng, s).to(dev)
        root = modarith.to_words(rng.integers(0, 1 << 64, size=(s, 4), dtype=np.uint64,
                                              endpoint=False), dev)
        fin = modarith.to_words(rng.integers(0, P, size=(s, 64), dtype=np.uint64), dev)
        for got, want in (
                (keccak.transcript_absorb(state, b"fri-layer-root", root),
                 keccak.transcript_absorb_plain(state, b"fri-layer-root", root)),
                (keccak.transcript_absorb(state, b"fri-final", fin, 64),
                 keccak.transcript_absorb_plain(state, b"fri-final", fin, 64)),
                (keccak.transcript_squeeze_field(state, b"fri-fold", 3),
                 keccak.transcript_squeeze_plain(state, b"fri-fold", 3, 1)),
                (keccak.transcript_squeeze_field(state, b"fri-fold", (1 << 32) - 1),
                 keccak.transcript_squeeze_plain(state, b"fri-fold", (1 << 32) - 1, 1)),
                (keccak.transcript_squeeze_indices(state, b"fri-query", 9, 30, 1 << 15),
                 keccak.transcript_squeeze_plain(state, b"fri-query", 9, 30, (1 << 15) - 1)),
                (keccak.transcript_final_queries(state, b"fri-final", fin, 64, b"fri-query", 255,
                                                 30, 1 << 15),
                 keccak.transcript_final_queries_plain(state, b"fri-final", fin, 64, b"fri-query",
                                                       255, 30, (1 << 15) - 1))):
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[-1].reshape(-1), want[-1].reshape(-1))
    words = lambda shape, high=P: modarith.to_words(
        rng.integers(0, high, size=shape, dtype=np.uint64, endpoint=False), dev)
    for rows, n in ((16, 1 << 16), (16, 1 << 13), (16, 1 << 10), (16, 1 << 17), (1, 1 << 16),
                    (1, 1 << 10), (128, 1 << 13), (32, 1 << 16), (1, 1 << 18), (1, 1 << 19),
                    (2, 2), (3, 8)):
        cur, inv_x, cs = words((rows, n)), words((n // 2,)), words((rows,))
        state, root = words((rows, 4), 1 << 64), words((rows, 4), 1 << 64)
        assert torch.equal(fri_fold.fold(cur, inv_x, cs), fri_fold.fold_plain(cur, inv_x, cs))
        for r in (None, root):
            got = fri_fold.fold_squeeze(cur, inv_x, state, 7, r)
            want = fri_fold.fold_squeeze_plain(cur, inv_x, state, 7, r)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
