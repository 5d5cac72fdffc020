"""Table generators, one module a generator, found by the name a
configuration file gives: `generate(rows, rng) -> (arrays, dictionaries)`.
They import nothing of the program under test."""
