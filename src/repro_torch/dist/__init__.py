"""repro_torch.dist — what one device needs of ``repro.dist``: the
error-feedback gradient compression and the analytic wire accounting."""
