"""The port's counterpart of the repository's ``__graft_entry__.entry()``:
the flagship step, the batched device prove stage (interpolation, odd-coset
quotient in kernel Q, Module-LWE commitment in kernel R), on tiny shapes.

    fn, args = entry()            # on the card
    q, a, b, c, commitment, valid = fn(*args)

The shapes and data are the JAX entry's: m = 16 multiplication gates over the
44-bit field, ring degree n = 32, k = 2, B = 2 statements whose evaluations
come from ``random.Random(0)``, and the threefry key of seed 0. The
evaluations are (B, m) int64 words where the JAX entry passes digit planes.
"""

from __future__ import annotations

import random

from .commit.lwe import LweContext
from .commit.lwe_device import DeviceCommitContext
from .core.params import NTT_FRIENDLY_MODULUS, Params, Profile, SecurityLevel
from .device import resolve
from .ops import modarith
from .ops.sampler import prng_key
from .pipeline import ProvePlan, prove_stage_batch


def tiny_problem(m: int, n_ring: int, batch: int):
    """(q, context, a, b, c) with (batch, m) evaluations a b = c, as lists."""
    q = NTT_FRIENDLY_MODULUS
    ctx = LweContext(Params(SecurityLevel.BITS128,
                            Profile.ring_b(n=n_ring, k=2, q=q, sigma=3.19)), context_seed=1)
    rng = random.Random(0)
    evs = []
    for _ in range(batch):
        a = [rng.randrange(1, q) for _ in range(m)]
        b = [rng.randrange(1, q) for _ in range(m)]
        evs.append((a, b, [(x * y) % q for x, y in zip(a, b)]))
    return q, ctx, *([e[i] for e in evs] for i in range(3))


def entry(device="cuda"):
    """(fn, example_args): the batched prove stage at m = 16, n = 32, B = 2."""
    dev = resolve(device)
    m, n_ring, batch = 16, 32, 2
    q, ctx, a_e, b_e, c_e = tiny_problem(m, n_ring, batch)
    pp = ProvePlan.create(m, q, DeviceCommitContext.from_host(ctx, dev))

    def fn(a_evals, b_evals, c_evals, key):
        return prove_stage_batch(pp, a_evals, b_evals, c_evals, key)

    return fn, (*(modarith.to_words(x, dev) for x in (a_e, b_e, c_e)), prng_key(0))
