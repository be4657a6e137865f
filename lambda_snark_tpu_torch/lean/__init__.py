"""lean subpackage of lambda_snark_tpu_torch: Lean 4 artifacts, the JAX package's bytes."""
