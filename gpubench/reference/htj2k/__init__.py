"""A frozen copy of the JAX package's host codec, the benchmark's plain
reference: openjph_tpu/codec.py, core/, coding/ (decoder.py,
encoder.py, data/vlc_tables.npz), ops/ (color.py, dwt.py) and
native/__init__.py, as of the benchmark's first version, with
coding/tables.py and native/ojtpu_native.cpp taken from
openjph_tpu_torch (the same code, its table build vectorised and its
C++ with its fix of padding significance in damaged multi-pass
codeblocks).  Changed beside
the imports, which stay relative: ``codec.encode`` always runs the host
encoder (the JAX dispatch removed), the C++ library builds into
<checkout>/build/gpubench/ and a failed build raises, and comments cite
OpenJPH's sources by their path in that project.  It imports nothing
of openjph_tpu, openjph_tpu_torch or jax."""
