"""The port's multi-device dry run (``entry.dryrun_multichip``) on the CPU.

``dryrun_multichip(2, device="cpu", backend="gloo")`` with ``DRYRUN_M=64``
starts a world of one (the (1, 1) references) and a world of two CPU ranks
(mesh (1, 2)) and runs the JAX dry run's legs (a)-(e) with its assertions:
the sharded step against the host quotient, the host commitment and the
(1, 1) run; batched kind 7 against sequential proofs and the device route
against the host route; the service with a resume against a (1, 1)
service; a kind-8 aggregate; kind 9 and the phase-2 checked proof. Leg (f)
(m = 2^12) is skipped under ``DRYRUN_M``, as in JAX. Every leg prints its
line from rank 0, and the record gives each leg's seconds, each rank's
kernel launches and the run's launches by shape (none on the CPU).
"""

import contextlib
import os
import sys

import pytest

from lambda_snark_tpu_torch.entry import dryrun_multichip

LEGS = {
    "a": "dryrun (a) sharded prove ok: mesh=(1x2), m=64, batch=2, quotient+commitment == host "
         "golden AND single-device bit-identical",
    "b": "dryrun (b) batched succinct ok: batch==sequential bytes; device route == host route "
         "bytes at m=2^6",
    "c": "dryrun (c) service stream ok: 2 proofs, resume + single-device bytes identical",
    "d": "dryrun (d) kind-8 aggregate ok: S=3, m=256, deterministic bytes + round-trip verify",
    "e": "dryrun (e) kind-9 witness + phase-2 ok: deterministic bytes + round-trip verify",
}


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """(rank 0's record, the lines printed): the ranks write to this
    process's standard output descriptor and the caller to ``sys.stdout``,
    both sent to one file."""
    path = tmp_path_factory.mktemp("dryrun") / "out.txt"
    env = pytest.MonkeyPatch()
    env.setenv("DRYRUN_M", "64")
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        with open(path, "w", buffering=1) as f, contextlib.redirect_stdout(f):
            os.dup2(f.fileno(), 1)
            record = dryrun_multichip(2, device="cpu", backend="gloo")
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)
        env.undo()
    return record, path.read_text().splitlines()


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_every_leg_passes_and_prints(dryrun, leg):
    record, lines = dryrun
    assert any(line.startswith(LEGS[leg] + " [") for line in lines), lines
    assert record["legs_s"][leg] > 0


def test_legs_in_order_and_f_skipped(dryrun):
    record, lines = dryrun
    legs = [line[len("dryrun ("):][0] for line in lines if line.startswith("dryrun (")]
    assert legs == ["a", "b", "c", "d", "e", "f"]
    assert any(line.startswith("dryrun (f) m=2^12 leg skipped") for line in lines)
    assert "f" not in record["legs_s"]
    assert lines[-1].startswith("dryrun_multichip ok: mesh=(1x2), m=64, batch=2, devices=2, ")


def test_no_kernel_launches_on_the_cpu(dryrun):
    record, _lines = dryrun
    assert len(record["launches"]) == 2
    assert all(not any(rank.values()) for rank in record["launches"])
    assert not any(record["reference_launches"].values())
    assert record["shapes"] == {}
