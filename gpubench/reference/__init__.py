"""The plain reference: a frozen copy of the JAX package's host codec
(``htj2k/``: numpy lifting and colour transforms, Tier-2 in Python, the
C++ scalar codeblock coders built by the benchmark itself), the
comparisons that decide ``correct`` (``compare``) and their control
(``control``).  It imports nothing of openjph_tpu_torch, openjph_tpu or
jax."""
