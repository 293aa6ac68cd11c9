"""A frozen copy of the plain PyTorch and numpy code of ``spacap3d_tpu_torch``
(its model, the plain versions of its ops, its losses, its dataset item
builder, its loader's schedule and its configs), with the imports
rewritten to this package and the kernels' wrappers cut to their plain
versions. The benchmark's reference runs it; it never changes with the
program. Docstrings are the copied modules' own."""
