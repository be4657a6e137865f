"""lambda_snark_tpu_torch: the PyTorch / CUDA port of lambda_snark_tpu.

It runs the batched and streamed prove stage (kinds 2 and 3) and the batched
succinct FRI prover (kind 7) of the JAX package on an NVIDIA H100 and gives
the same proof bytes; it reads, verifies and stores its proofs and the JAX
package's (kinds 2, 3, 6 and 7). It imports torch, numpy and the standard library
only, never ``jax`` or ``lambda_snark_tpu``. Entry points default to
``device="cuda"`` and raise without a card unless given ``device="cpu"``,
where every kernel runs as its plain PyTorch twin.
"""

from .circuits.examples import multiplication_gates_circuit, multiplication_gates_witness
from .commit.lwe import Commitment, LweContext
from .core.errors import DomainError, InvalidWitnessError, SerializationError
from .core.params import (
    NTT_FRIENDLY_MODULUS,
    NTT_MODULUS,
    Params,
    Profile,
    SecurityLevel,
)
from .entry import entry
from .prover_batched import prove_r1cs_batched, prove_r1cs_stream
from .proof.fri import FriParams
from .proof.polynomial import Polynomial
from .proof.succinct import SuccinctProofR1CS, prove_r1cs_succinct, verify_r1cs_succinct
from .proof.succinct_batch import prove_r1cs_succinct_batch
from .proof.types import EvalOpening, ProofR1CS, ProofR1csZk, deserialize_any
from .utils.artifacts import ProofStore, circuit_digest, statement_digest
from .verifier import verify_r1cs, verify_r1cs_zk
