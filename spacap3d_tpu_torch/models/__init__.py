from spacap3d_tpu_torch.models.spacap import SpaCapNet, init_spacap  # noqa: F401
