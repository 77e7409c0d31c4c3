"""The fuzz harnesses of the port (fuzzing/fuzz_decode.py and
fuzzing/fuzz_encode.py of the JAX package, without JAX): mutated
streams and random encode parameters through the port on a device,
held against the port's own CPU path."""
