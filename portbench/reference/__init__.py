"""The plain reference the benchmark holds the program to: the codec
(`codec.py`), its coding tables and the rANS coder's byte count
(`coding.py`), and the train step (`train.py`), in plain PyTorch and NumPy
from the published description of the codec (a scale hyperprior with GDN,
task heads, the mixed, disjoint and shared latents). It imports nothing of
`mmnc_tpu_torch`, `mmnc_tpu` or JAX, and takes nothing the program made:
it works out the coding tables, medians, indexes, noise and optimizer
updates again from the weights and inputs the benchmark made."""
