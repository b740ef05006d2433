"""mecat_tpu_torch.cli"""
