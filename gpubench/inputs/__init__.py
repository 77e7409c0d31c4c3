"""The benchmark's own inputs: seeded frames and the codestreams its
frozen reference encoder makes of them (never the port's encoder, so a
change to the port cannot move the decode cells' inputs)."""
