"""The port's command lines: ``python -m spacap3d_tpu_torch.scripts.<name>``
with ``train``, ``eval``, ``overfit_gate`` and ``profile_step``."""
