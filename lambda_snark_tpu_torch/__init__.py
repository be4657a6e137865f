"""lambda_snark_tpu_torch: the PyTorch / CUDA port of lambda_snark_tpu.

It runs the JAX package's batched and streamed prove stage (kinds 2 and 3),
its succinct FRI provers (kind 7, plain and zero-knowledge: the batch,
its chunk-pipelined form and the stream), its aggregated proofs (kind 8)
and its committed-witness proofs (kind 9: single, batch and stream) on an
NVIDIA H100 and gives the same proof bytes; its host provers
(``prover``: kinds 1, 2, 3 and 6; compact kinds 4 and 5; the phase-2
checked proof; kinds 7 and 9 off the Goldilocks fast front end) are the
golden path on Python ints. It reads, verifies and stores its proofs and
the JAX package's (kinds 1 to 9). ``python -m lambda_snark_tpu_torch`` is
its command line (``cli``), the JAX package's with ``--device``. It imports torch, numpy
and the standard library only, never ``jax`` or ``lambda_snark_tpu``.
Device entry points default to ``device="cuda"`` and raise without a card
unless given ``device="cpu"``, where every kernel runs as its plain
PyTorch twin.
"""

from .circuits.examples import (
    multiplication_circuit,
    multiplication_gates_circuit,
    multiplication_gates_witness,
    range_proof_circuit,
    range_proof_witness,
)
from .commit.lwe import Commitment, LweContext, commit, linear_combine, verify_opening
from .core.errors import (
    CommitmentError,
    DomainError,
    InvalidDimensionsError,
    InvalidInputError,
    InvalidParamsError,
    InvalidWitnessError,
    LambdaSnarkError,
    SerializationError,
)
from .core.params import (
    LEGACY_COMPOSITE_MODULUS,
    LEGACY_MODULUS,
    NTT_FRIENDLY_MODULUS,
    NTT_MODULUS,
    NTT_PRIMITIVE_ROOT,
    ROOTS_OF_UNITY_45BIT,
    Params,
    Profile,
    SecurityLevel,
    Witness,
)
from .entry import entry
from .prover import prove_r1cs, prove_r1cs_zk, prove_simple, prove_zk, setup, simulate_proof
from .prover_batched import prove_r1cs_batched, prove_r1cs_stream
from .proof.aggregate import (
    AggregatedProofR1CS,
    prove_r1cs_succinct_aggregate,
    verify_r1cs_succinct_aggregate,
)
from .proof.checks import prove_r1cs_checked, verify_r1cs_checked
from .proof.compact import CompactProofR1CS, prove_r1cs_compact, verify_r1cs_compact
from .proof.fri import FriParams
from .proof.polynomial import Polynomial
from .proof.succinct import (
    SuccinctProofR1CS,
    SuccinctView,
    prove_r1cs_succinct,
    simulate_succinct_view,
    succinct_view,
    verify_r1cs_succinct,
)
from .proof.succinct_batch import (
    prove_r1cs_succinct_batch,
    prove_r1cs_succinct_stream,
    prove_r1cs_witness_batch,
)
from .proof.succinct_witness import WitnessProofR1CS, prove_r1cs_witness, verify_r1cs_witness
from .proof.types import EvalOpening, Proof, ProofR1CS, ProofR1csZk, deserialize_any
from .r1cs.circuit import CircuitBuilder
from .r1cs.domain import Domain
from .r1cs.r1cs import R1CS
from .r1cs.sparse import SparseMatrix
from .transcript.challenge import Challenge, derive_dual
from .utils.artifacts import ProofStore, circuit_digest, statement_digest
from .utils.chacha import ChaCha20Rng
from .verifier import (
    verify_r1cs,
    verify_r1cs_with_context,
    verify_r1cs_zk,
    verify_simple,
)

__version__ = "0.8.0"

__all__ = [
    "AggregatedProofR1CS",
    "ChaCha20Rng",
    "Challenge",
    "circuit_digest",
    "CircuitBuilder",
    "commit",
    "Commitment",
    "CommitmentError",
    "CompactProofR1CS",
    "derive_dual",
    "deserialize_any",
    "Domain",
    "DomainError",
    "entry",
    "EvalOpening",
    "FriParams",
    "InvalidDimensionsError",
    "InvalidInputError",
    "InvalidParamsError",
    "InvalidWitnessError",
    "LambdaSnarkError",
    "LEGACY_COMPOSITE_MODULUS",
    "LEGACY_MODULUS",
    "linear_combine",
    "LweContext",
    "multiplication_circuit",
    "multiplication_gates_circuit",
    "multiplication_gates_witness",
    "NTT_FRIENDLY_MODULUS",
    "NTT_MODULUS",
    "NTT_PRIMITIVE_ROOT",
    "Params",
    "Polynomial",
    "Profile",
    "Proof",
    "ProofR1CS",
    "ProofR1csZk",
    "ProofStore",
    "prove_r1cs",
    "prove_r1cs_batched",
    "prove_r1cs_checked",
    "prove_r1cs_compact",
    "prove_r1cs_stream",
    "prove_r1cs_succinct",
    "prove_r1cs_succinct_aggregate",
    "prove_r1cs_succinct_batch",
    "prove_r1cs_succinct_stream",
    "prove_r1cs_witness",
    "prove_r1cs_witness_batch",
    "prove_r1cs_zk",
    "prove_simple",
    "prove_zk",
    "R1CS",
    "range_proof_circuit",
    "range_proof_witness",
    "ROOTS_OF_UNITY_45BIT",
    "SecurityLevel",
    "SerializationError",
    "setup",
    "simulate_proof",
    "simulate_succinct_view",
    "SparseMatrix",
    "statement_digest",
    "succinct_view",
    "SuccinctProofR1CS",
    "SuccinctView",
    "verify_opening",
    "verify_r1cs",
    "verify_r1cs_checked",
    "verify_r1cs_compact",
    "verify_r1cs_succinct",
    "verify_r1cs_succinct_aggregate",
    "verify_r1cs_with_context",
    "verify_r1cs_witness",
    "verify_r1cs_zk",
    "verify_simple",
    "Witness",
    "WitnessProofR1CS",
]
