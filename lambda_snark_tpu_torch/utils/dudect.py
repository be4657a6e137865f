"""dudect-style constant-time evidence (two-class Welch t-test).

Parity with the reference timing tools — the C++ ``dudect_sampler``
(``cpp-core/tools/dudect_sampler.cpp``: Welch t over ``sample_gaussian``) and
the Rust ``mod_arith_timing`` binary
(``rust-api/lambda-snark/src/bin/mod_arith_timing.rs``: odd/even-exponent
``mod_pow`` classes) — writing the same style of markdown reports under
``artifacts/dudect/``.

The port's copy of the JAX package's ``utils/dudect.py``, with the same
reports. The CUDA kernels run fixed, data-independent schedules, so the
interesting surface is the *host* golden path used for small circuits;
that is what these harnesses measure. The report records the caveat either
way.
"""

from __future__ import annotations

import math
import os
import statistics
import time
from typing import Callable, List, Sequence, Tuple

from ..core import field


def welch_t(a: Sequence[float], b: Sequence[float]) -> float:
    """Welch's t statistic (reference ``dudect_sampler.cpp:61-73``)."""
    if len(a) < 2 or len(b) < 2:
        return 0.0
    ma, mb = statistics.fmean(a), statistics.fmean(b)
    va, vb = statistics.variance(a), statistics.variance(b)
    denom = math.sqrt(va / len(a) + vb / len(b))
    if denom == 0.0:
        return 0.0
    return (ma - mb) / denom


def _time_ns(fn: Callable[[], object]) -> float:
    t0 = time.perf_counter_ns()
    fn()
    return float(time.perf_counter_ns() - t0)


def two_class_timing(
    class_a: Callable[[], object],
    class_b: Callable[[], object],
    samples: int = 5000,
    drop_frac: float = 0.1,
) -> Tuple[float, List[float], List[float]]:
    """Interleaved two-class timing; drops the top fraction (OS noise)."""
    times_a: List[float] = []
    times_b: List[float] = []
    for _ in range(samples):
        times_a.append(_time_ns(class_a))
        times_b.append(_time_ns(class_b))
    times_a.sort()
    times_b.sort()
    keep = int(samples * (1.0 - drop_frac))
    a, b = times_a[:keep], times_b[:keep]
    return welch_t(a, b), a, b


def mod_pow_timing_report(
    modulus: int, samples: int = 4000, out_dir: str = "artifacts/dudect"
) -> str:
    """Odd- vs even-exponent ``mod_pow`` classes (mod_arith_timing parity)."""
    import random

    rng = random.Random(7)
    base = rng.randrange(2, modulus)
    exp_odd = rng.randrange(1 << 40, 1 << 44) | 1
    exp_even = exp_odd & ~1

    t_stat, a, b = two_class_timing(
        lambda: field.mod_pow(base, exp_odd, modulus),
        lambda: field.mod_pow(base, exp_even, modulus),
        samples=samples,
    )
    verdict = "PASS (|t| < 4.5)" if abs(t_stat) < 4.5 else "INVESTIGATE"
    report = f"""# mod_arith timing report (dudect-style)

Two-class Welch t-test over `mod_pow` with odd vs even exponents
(reference: `rust-api/lambda-snark/src/bin/mod_arith_timing.rs`).

- modulus: {modulus}
- samples per class: {samples} (top 10% dropped)
- mean class A (odd exp): {statistics.fmean(a):.1f} ns
- mean class B (even exp): {statistics.fmean(b):.1f} ns
- Welch t statistic: {t_stat:.3f}
- verdict: {verdict}

Note: the host golden path uses Python integers (not constant time by
construction); the device path executes fixed data-independent SIMD
schedules. This report characterizes the host path only.
"""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "mod_arith_report.md")
    with open(path, "w") as f:
        f.write(report)
    return path


def gaussian_timing_report(
    sigma: float = 3.19, samples: int = 2000, out_dir: str = "artifacts/dudect"
) -> str:
    """Two-class Gaussian sampler timing (dudect_sampler parity): fixed-seed
    class vs random-seed class over the native CT sampler when available,
    else the Python vectorized sampler."""
    import hashlib
    import secrets

    from .. import native_bridge as nb
    from ..ops import gaussian
    from .chacha import ChaCha20Rng

    fixed_key = hashlib.sha3_256(b"dudect-fixed").digest()
    use_native = nb.available()

    if use_native:
        class_a = lambda: nb.sample_gaussian_seeded(64, sigma, fixed_key)
        class_b = lambda: nb.sample_gaussian_seeded(
            64, sigma, secrets.token_bytes(32)
        )
        backend = "native C++ constant-time scan"
    else:
        cdf = gaussian.build_cdf(sigma)
        class_a = lambda: gaussian.sample_signed_vectorized(
            ChaCha20Rng(fixed_key), cdf, 64
        )
        class_b = lambda: gaussian.sample_signed_vectorized(
            ChaCha20Rng(secrets.token_bytes(32)), cdf, 64
        )
        backend = "python vectorized"

    t_stat, a, b = two_class_timing(class_a, class_b, samples=samples)
    verdict = "PASS (|t| < 4.5)" if abs(t_stat) < 4.5 else "INVESTIGATE"
    report = f"""# gaussian sampler timing report (dudect-style)

Two-class Welch t-test over the CDT discrete Gaussian sampler
(reference: `cpp-core/tools/dudect_sampler.cpp`).

- sigma: {sigma} (tail cutoff 12 sigma, ~2^-72 mass)
- backend: {backend}
- samples per class: {samples} (64 draws each, top 10% dropped)
- mean class A (fixed seed): {statistics.fmean(a):.1f} ns
- mean class B (random seed): {statistics.fmean(b):.1f} ns
- Welch t statistic: {t_stat:.3f}
- verdict: {verdict}
"""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "gaussian_sampler_report.md")
    with open(path, "w") as f:
        f.write(report)
    return path
