"""Seeded generators of the benchmark's inputs, found by the name a
traffic file gives them."""
