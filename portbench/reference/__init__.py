"""The benchmark's plain references: plain PyTorch and numpy that import
neither JAX nor anything of the measured program.  ``sift`` is a frozen
copy of the port's plain SIFT path; ``scenes`` makes every input from a
seed; ``match`` is the plain ratio-test matcher; ``compare`` turns a
program's outputs and the reference's into the numbers held to limits."""
