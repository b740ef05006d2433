"""mecat_tpu_torch.ops"""
