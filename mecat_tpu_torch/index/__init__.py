"""mecat_tpu_torch.index"""
