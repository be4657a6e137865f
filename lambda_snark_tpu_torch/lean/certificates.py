"""Regeneration of the reference's Lean certificate data from this stack.

The reference's formal layer consumes concrete circuit data committed as
Lean test files "exported from Rust" (``formal/tests/HealthcareCircuit.lean``,
``HealthcareWitnessData.lean``). ROADMAP #11: prove those certificates are
regenerable from *this* framework — parse the committed Lean data, compare
it structurally against the circuit built here, and emit an equivalent
data file so the existing Lean proofs (satisfiability, primitive-root and
quotient lemmas) keep type-checking against artifacts produced by this
stack. This is the port's copy of the JAX package's module; its text is the
same byte for byte (the emitted headers keep the name lambda-snark-tpu).

Only the *data* declarations are regenerated (matrices, witness, public
inputs, modulus); the lemmas/proof scripts in the reference files are
hand-written Lean and are left to the formal layer, exactly per
SURVEY.md §7 step 10 ("keep emitting the same artifact formats so the
existing proofs remain consumable").
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import Dict, List, Sequence, Tuple

Entry = Tuple[int, int, int]


def _parse_value(text: str, q: int) -> int:
    """Lean field literal -> canonical int mod q: ``1``, ``(2 : F)``,
    ``(-1 : HealthcareField)``."""
    text = text.strip()
    m = re.match(r"^\(?\s*(-?\d+)", text)
    if not m:
        raise ValueError(f"unparseable Lean field literal: {text!r}")
    return int(m.group(1)) % q


def parse_reference_circuit(source: str) -> Dict:
    """Extract (q, A/B/C entries, witness) from a HealthcareCircuit.lean-
    style file. Returns canonical ints mod q."""
    qm = re.search(r"def q : ℕ := (\d+)", source)
    if not qm:
        raise ValueError("modulus declaration not found")
    q = int(qm.group(1))
    mats: Dict[str, List[Entry]] = {}
    for name in "ABC":
        block = re.search(
            rf"healthcareMatrix{name}[^{{]*{{(.*?)}}", source, re.S
        )
        if not block:
            raise ValueError(f"matrix {name} not found")
        entries = []
        for em in re.finditer(
            r"\(\s*(\d+)\s*,\s*(\d+)\s*,\s*((?:\([^)]*\))|(?:-?\d+))\s*\)",
            block.group(1),
        ):
            entries.append(
                (int(em.group(1)), int(em.group(2)),
                 _parse_value(em.group(3), q))
            )
        mats[name] = entries
    witness = {}
    wit_block = re.search(
        r"def healthcareWitness[^|]*((?:\s*\|[^\n]*\n)+)", source
    )
    if wit_block:
        for wm in re.finditer(
            r"\|\s*⟨(\d+),\s*_⟩\s*=>\s*(-?\d+)", wit_block.group(1)
        ):
            witness[int(wm.group(1))] = int(wm.group(2)) % q
    dims = re.search(
        r"nVars := (\d+)\s*nCons := (\d+)\s*nPub := (\d+)", source
    )
    return {
        "q": q,
        "A": mats["A"],
        "B": mats["B"],
        "C": mats["C"],
        "witness": [witness[i] for i in sorted(witness)],
        "n_vars": int(dims.group(1)) if dims else None,
        "n_cons": int(dims.group(2)) if dims else None,
        "n_pub": int(dims.group(3)) if dims else None,
    }


def _coo_entries(mat, q: int) -> List[Entry]:
    """CSR SparseMatrix -> row-major COO entries with canonical values."""
    return [(r, c, int(v) % q) for r, c, v in mat.coo()]


def circuit_coo(r1cs) -> Dict[str, List[Entry]]:
    q = r1cs.modulus
    return {
        "A": _coo_entries(r1cs.a, q),
        "B": _coo_entries(r1cs.b, q),
        "C": _coo_entries(r1cs.c, q),
    }


def _lean_value(v: int, q: int, field: str) -> str:
    """Render canonical v with the reference's -1 convention."""
    if v == q - 1:
        return f"(-1 : {field})"
    if v == 1:
        return "1"
    return f"({v} : {field})"


def certificate_data_lean(r1cs, witness: Sequence[int],
                          field: str = "HealthcareField") -> str:
    """Emit the certificate *data* declarations in the reference's test-file
    shape (matrices, R1CS instance, witness) from a circuit built here."""
    q = r1cs.modulus
    coo = circuit_coo(r1cs)
    lines = [
        "/- Regenerated certificate data (lambda-snark-tpu; reference",
        "   format: formal/tests/HealthcareCircuit.lean). -/",
        "",
        f"private def q : ℕ := {q}",
        "",
        f"@[simp] abbrev {field} : Type := ZMod q",
        "",
    ]
    for name in "ABC":
        entries = coo[name]
        lines.append(
            f"noncomputable def healthcareMatrix{name} : SparseMatrix {field} :="
        )
        lines.append(f"  {{ nRows := {r1cs.m}")
        lines.append(f"    nCols := {r1cs.n}")
        if entries:
            body = [
                f"      [ ({r}, {c}, {_lean_value(v, q, field)})"
                if i == 0
                else f"      , ({r}, {c}, {_lean_value(v, q, field)})"
                for i, (r, c, v) in enumerate(entries)
            ]
            lines.append("    entries :=")
            lines.extend(body)
            lines.append("      ] }")
        else:
            lines.append("    entries := [] }")
        lines.append("")
    lines.append(f"noncomputable def healthcareR1CS : R1CS {field} :=")
    lines.append(f"  {{ nVars := {r1cs.n}")
    lines.append(f"    nCons := {r1cs.m}")
    lines.append(f"    nPub := {r1cs.l}")
    lines.append("    A := healthcareMatrixA")
    lines.append("    B := healthcareMatrixB")
    lines.append("    C := healthcareMatrixC")
    lines.append("    h_dim_A := by constructor <;> decide")
    lines.append("    h_dim_B := by constructor <;> decide")
    lines.append("    h_dim_C := by constructor <;> decide")
    lines.append("    h_pub_le := by decide }")
    lines.append("")
    lines.append(
        f"noncomputable def healthcareWitness : "
        f"Witness {field} healthcareR1CS.nVars"
    )
    for i, v in enumerate(witness):
        lines.append(f"  | ⟨{i}, _⟩ => {int(v) % q}")
    lines.append("")
    return "\n".join(lines)


# --- HealthcareWitnessData.lean ------------------------------------------------
#
# The reference file (formal/tests/HealthcareWitnessData.lean) carries no
# literals: every vector is *derived* from HealthcareCircuit.lean --
# healthcareWitnessVector/-PublicVector wrap the witness, the domain vector is
# healthcareOmega^i with healthcareOmega = primitiveRoot(q)^((q-1)/10), and
# healthcareConstraintResiduals are the per-constraint values
# (Az)_i (Bz)_i - (Cz)_i (proved zero by healthcareConstraintResiduals_zero).
# Regeneration therefore means: compute the same quantities from the circuit
# built HERE and emit them as explicit data the Lean side can cross-check.


def least_primitive_root(q: int) -> int:
    """Smallest primitive root mod prime q (the generator Mathlib-style
    ``ZMod.primitiveRoot`` denotes for the healthcare field)."""
    n = q - 1
    fs = set()
    d, t = 2, n
    while d * d <= t:
        while t % d == 0:
            fs.add(d)
            t //= d
        d += 1
    if t > 1:
        fs.add(t)
    g = 2
    while any(pow(g, n // p, q) == 1 for p in fs):
        g += 1
    return g


def healthcare_omega(q: int, order: int = 10) -> int:
    """The primitive ``order``-th root of unity the reference's
    HealthcareWitnessData.lean derives: primitiveRoot(q)^((q-1)/order)."""
    if (q - 1) % order:
        raise ValueError(f"{order} does not divide q-1")
    omega = pow(least_primitive_root(q), (q - 1) // order, q)
    # primitivity check (order = 2*5 here: enough to rule out proper divisors)
    for p in {2, 5} if order == 10 else set(
        d for d in range(2, order + 1) if order % d == 0 and _is_prime(d)
    ):
        if pow(omega, order // p, q) == 1:
            raise ValueError("derived omega is not primitive")
    return omega


def _is_prime(v: int) -> bool:
    if v < 2:
        return False
    d = 2
    while d * d <= v:
        if v % d == 0:
            return False
        d += 1
    return True


def constraint_residuals(r1cs, witness: Sequence[int]) -> List[int]:
    """Per-constraint residuals (Az)_i (Bz)_i - (Cz)_i mod q -- the values
    of ``healthcareConstraintResiduals`` (zero for a satisfying witness)."""
    q = r1cs.modulus
    z = [int(v) % q for v in witness]
    az = r1cs.a.mul_vec(z, q)
    bz = r1cs.b.mul_vec(z, q)
    cz = r1cs.c.mul_vec(z, q)
    return [(a * b - c) % q for a, b, c in zip(az, bz, cz)]


def witness_data_lean(r1cs, witness: Sequence[int],
                      field: str = "HealthcareField") -> str:
    """Emit the HealthcareWitnessData quantities as explicit data lists:
    witness vector, public prefix, domain points omega^i and constraint
    residuals (reference derivations: formal/tests/HealthcareWitnessData.lean
    lines 19-79)."""
    q = r1cs.modulus
    omega = healthcare_omega(q, r1cs.m)
    z = [int(v) % q for v in witness]
    pub = z[: r1cs.l]
    domain = [pow(omega, i, q) for i in range(r1cs.m)]
    residuals = constraint_residuals(r1cs, witness)

    def vec(name: str, vals: List[int], count: str) -> List[str]:
        body = ", ".join(str(v) for v in vals)
        return [
            f"noncomputable def {name} : Vector {field} {count} :=",
            f"  ⟨[{body}], by decide⟩",
            "",
        ]

    lines = [
        "/- Regenerated witness-data certificate (lambda-snark-tpu; reference",
        "   derivations: formal/tests/HealthcareWitnessData.lean). Explicit",
        "   values for the vectors the reference defines by derivation;",
        f"   healthcareOmega = {least_primitive_root(q)}^((q-1)/{r1cs.m})",
        f"   = {omega} (least primitive root of q = {q}). -/",
        "",
    ]
    lines += vec("healthcareWitnessVector", z, "healthcareR1CS.nVars")
    lines += vec("healthcarePublicVector", pub, "healthcareR1CS.nPub")
    lines += vec("healthcareDomainVector", domain, "healthcareR1CS.nVars")
    lines += vec(
        "healthcareConstraintResiduals", residuals, "healthcareR1CS.nCons"
    )
    return "\n".join(lines)


# --- ForkingCertificateExample.lean --------------------------------------------


def parse_forking_example(source: str) -> Dict:
    """Extract the trivial-circuit data from ForkingCertificateExample.lean:
    the ZMod field size, trivial matrix dims/entries, R1CS dims, and the two
    stub transcript alphas (the fork point)."""
    fm = re.search(r"SparseMatrix \(ZMod (\d+)\)", source)
    if not fm:
        raise ValueError("trivial matrix field not found")
    q = int(fm.group(1))
    mm = re.search(
        r"trivialSparseMatrix[^\n]*(?:where|:=\s*{)\s*"
        r"nRows := (\d+)\s*nCols := (\d+)\s*entries := \[(.*?)\]",
        source,
        re.S,
    )
    if not mm:
        raise ValueError("trivial matrix body not found")
    rm = re.search(
        r"trivialR1CS[^\n]*(?:where|:=\s*{)\s*"
        r"nVars := (\d+)\s*nCons := (\d+)\s*nPub := (\d+)",
        source,
        re.S,
    )
    if not rm:
        raise ValueError("trivial R1CS dims not found")
    alphas = [int(a) for a in re.findall(r"alpha := (\d+)", source)]
    return {
        "q": q,
        "n_rows": int(mm.group(1)),
        "n_cols": int(mm.group(2)),
        "entries": [e for e in mm.group(3).split(",") if e.strip()],
        "n_vars": int(rm.group(1)),
        "n_cons": int(rm.group(2)),
        "n_pub": int(rm.group(3)),
        "alphas": alphas,
    }


def forking_example_data_lean(data: Dict) -> str:
    """Re-emit the trivial forking-certificate data in the reference shape."""
    q = data["q"]
    lines = [
        "/- Regenerated forking-certificate example data (lambda-snark-tpu;",
        "   reference: formal/tests/ForkingCertificateExample.lean). -/",
        "",
        f"def trivialSparseMatrix : SparseMatrix (ZMod {q}) where",
        f"  nRows := {data['n_rows']}",
        f"  nCols := {data['n_cols']}",
        "  entries := []",
        "",
        f"def trivialR1CS : R1CS (ZMod {q}) where",
        f"  nVars := {data['n_vars']}",
        f"  nCons := {data['n_cons']}",
        f"  nPub := {data['n_pub']}",
        "  A := trivialSparseMatrix",
        "  B := trivialSparseMatrix",
        "  C := trivialSparseMatrix",
        "  h_dim_A := by simp [trivialSparseMatrix]",
        "  h_dim_B := by simp [trivialSparseMatrix]",
        "  h_dim_C := by simp [trivialSparseMatrix]",
        "  h_pub_le := by decide",
        "",
        f"-- fork point: transcript alphas {data['alphas']}",
    ]
    return "\n".join(lines)


# --- ForkProbabilityBounds.lean -------------------------------------------------


def parse_fork_probability_bounds(source: str) -> List[Tuple[int, Fraction]]:
    """Extract every (q, epsilon) pair exercised by the fork_success_bound
    regression lemmas: statements of shape ``1 >= (eps)^2/2 - 1/(q)``."""
    pairs: List[Tuple[int, Fraction]] = []
    pat = re.compile(
        r"1 ≥ (.+?) \^ 2 / 2 - 1 / \((\d+) : ℝ\)"
    )
    for m in pat.finditer(source):
        eps_text = (
            m.group(1)
            .replace("(", " ")
            .replace(")", " ")
            .replace(": ℝ", " ")
            .replace(":", " ")
            .replace("ℝ", " ")
            .strip()
        )
        if "/" in eps_text:
            num, den = eps_text.split("/")
            eps = Fraction(int(num.strip()), int(den.strip()))
        else:
            eps = Fraction(int(eps_text))
        pairs.append((int(m.group(2)), eps))
    if not pairs:
        raise ValueError("no fork_success_bound statements found")
    return pairs


def check_fork_success_bound(q: int, eps: Fraction) -> bool:
    """Exact-arithmetic check of the forking lower-bound inequality the Lean
    lemmas pin: 1 >= eps^2/2 - 1/q (fork_success_bound, Soundness.lean /
    Forking/HeavyLight.lean: success >= eps^2/2 - 1/|F|)."""
    return Fraction(1) >= eps * eps / 2 - Fraction(1, q)


# --- HealthcareForkingEquations.lean --------------------------------------------


def parse_forking_equations(source: str) -> Dict:
    """Extract the data-bearing inputs of HealthcareForkingEquations.lean:
    the ModuleSIS hardness parameters and the square-domain property."""
    sis = re.search(r"ModuleSIS_Hard (\d+) (\d+) (\d+) (\d+)", source)
    if not sis:
        raise ValueError("ModuleSIS_Hard parameters not found")
    square = re.search(
        r"healthcare_square\s*:\s*\n?\s*healthcareR1CS.nVars = "
        r"healthcareR1CS.nCons",
        source,
    )
    return {
        "sis_n": int(sis.group(1)),
        "sis_k": int(sis.group(2)),
        "sis_q": int(sis.group(3)),
        "sis_beta": int(sis.group(4)),
        "asserts_square_domain": square is not None,
    }


# --- SecurityParamsData.lean -----------------------------------------------------


def security_params_lean() -> str:
    """Emit the security-parameter data certificate (docs/security_analysis.md
    §5): the shipped FRI defaults, mask arithmetic, the kind-8 batching
    envelope and the 2-adicity facts, as Lean ``example : _ := by decide``
    statements. Regenerated from the LIBRARY constants so the certificate
    cannot drift from the code; type-checked by ``scripts/lean_check.py``.
    """
    from ..core.params import (
        HEALTHCARE_DUMP_MODULUS,
        NTT_FRIENDLY_MODULUS,
        NTT_MODULUS,
    )
    from ..proof.fri import MAX_AGGREGATE_STATEMENTS, FriParams
    from ..proof.succinct import _MASK_LEN_CAP, _degree_bound

    p = FriParams()
    mask_len = 2 * p.num_queries + 8
    # the documented kind-8 operating envelope: m <= 2^13, ZK masks on
    d_max = _degree_bound(1 << 13, mask_len)
    target_bits = 80
    batch_slack_bits = 30
    lines = [
        "/- Regenerated security-parameter certificate (lambda-snark-tpu;",
        "   analysis: docs/security_analysis.md §5). Every `example` is a",
        "   kernel-checked arithmetic fact about the SHIPPED defaults. -/",
        "",
        f"private def friLogBlowup : ℕ := {p.log_blowup}",
        f"private def friNumQueries : ℕ := {p.num_queries}",
        f"private def friFinalLen : ℕ := {p.final_len}",
        "private def conjecturedProximityBits : ℕ := "
        "friLogBlowup * friNumQueries",
        f"private def targetProximityBits : ℕ := {target_bits}",
        "",
        "/-- Default profile meets the conjectured-regime proximity target. -/",
        "example : targetProximityBits ≤ conjecturedProximityBits := by decide",
        "",
        f"private def zkMaskLen : ℕ := {mask_len}",
        f"private def maskLenCap : ℕ := {_MASK_LEN_CAP}",
        "",
        "/-- The ZK mask covers every revealed position: 2 per query (paired",
        "    leaves) plus the out-of-domain evaluation slots. -/",
        "example : 2 * friNumQueries + 8 ≤ zkMaskLen := by decide",
        "example : zkMaskLen ≤ maskLenCap := by decide",
        "",
        f"private def goldilocksQ : ℕ := {NTT_MODULUS}",
        f"private def q45 : ℕ := {NTT_FRIENDLY_MODULUS}",
        f"private def healthcareQ : ℕ := {HEALTHCARE_DUMP_MODULUS}",
        f"private def maxAggregateStatements : ℕ := {MAX_AGGREGATE_STATEMENTS}",
        f"private def dMaxEnvelope : ℕ := {d_max}",
        "",
        "/-- Kind-8 λ-batching loss ≤ 2⁻³⁰ over the full wire envelope:",
        "    (8·S_max)·d_max / q ≤ 2⁻³⁰ (docs/security_analysis.md §3). -/",
        "example : 8 * maxAggregateStatements * dMaxEnvelope * "
        f"2 ^ {batch_slack_bits} ≤ goldilocksQ := by decide",
        "",
        "/-- Registered 2-adic subgroup orders divide q − 1 (the root-ladder",
        "    facts every coset argument relies on; proof/fri.py registry). -/",
        "example : 2 ^ 32 ∣ (goldilocksQ - 1) := by decide",
        "example : 2 ^ 13 ∣ (q45 - 1) := by decide",
        "example : 2 ^ 27 ∣ (healthcareQ - 1) := by decide",
    ]
    return "\n".join(lines) + "\n"
