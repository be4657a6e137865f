"""Healthcare diagnosis circuit (the port's copy of the JAX package's
``circuits/healthcare.py``): three binary threshold flags (x (x - 1) = 0),
a two-stage AND gate, the risk score 1 + 2 all_high and four padding
constraints (m = 10), with public inputs [1, risk_score].
"""

from __future__ import annotations

from typing import List, Optional

from ..r1cs.circuit import CircuitBuilder
from ..r1cs.domain import Domain
from ..r1cs.r1cs import R1CS

GLUCOSE_THRESHOLD = 126
AGE_THRESHOLD = 40
BMI_THRESHOLD = 30


def build_healthcare_circuit(modulus: int, domain: Optional[Domain] = None) -> R1CS:
    b = CircuitBuilder(modulus)
    one = b.alloc_var()          # z_0 = 1 (public constant)
    risk_score = b.alloc_var()   # z_1 (public output)
    _glucose = b.alloc_var()     # z_2 private, unconstrained
    _age = b.alloc_var()         # z_3 private, unconstrained
    _bmi = b.alloc_var()         # z_4 private, unconstrained
    glucose_high = b.alloc_var()  # z_5
    age_high = b.alloc_var()      # z_6
    bmi_high = b.alloc_var()      # z_7

    # booleanity: x * (x - 1) = 0
    for flag in (glucose_high, age_high, bmi_high):
        b.add_constraint([(flag, 1)], [(flag, 1), (one, modulus - 1)], [])

    # AND gate: all_high = glucose_high * age_high * bmi_high
    temp = b.alloc_var()      # z_8
    all_high = b.alloc_var()  # z_9
    b.add_constraint([(glucose_high, 1)], [(age_high, 1)], [(temp, 1)])
    b.add_constraint([(temp, 1)], [(bmi_high, 1)], [(all_high, 1)])

    # risk score = 1 + 2 * all_high
    b.add_constraint([(one, 1), (all_high, 2)], [(one, 1)], [(risk_score, 1)])

    # padding to m = 10
    for _ in range(4):
        b.add_constraint([], [], [])

    b.set_public_inputs(2)
    return b.build(domain=domain)


def make_witness(modulus: int, glucose: int, age: int, bmi: int) -> List[int]:
    glucose_high = 1 if glucose > GLUCOSE_THRESHOLD else 0
    age_high = 1 if age > AGE_THRESHOLD else 0
    bmi_high = 1 if bmi > BMI_THRESHOLD else 0
    temp = glucose_high * age_high
    all_high = temp * bmi_high
    risk_score = 1 + 2 * all_high
    return [
        1, risk_score, glucose % modulus, age % modulus, bmi % modulus,
        glucose_high, age_high, bmi_high, temp, all_high,
    ]


def high_risk_witness(modulus: int) -> List[int]:
    """Reference ``high_risk_witness``: glucose=142, age=45, bmi=31 -> risk 3."""
    return make_witness(modulus, 142, 45, 31)


def low_risk_witness(modulus: int) -> List[int]:
    """Reference ``low_risk_witness``: all metrics below thresholds -> risk 1."""
    return make_witness(modulus, 100, 35, 25)
