"""mecat_tpu_torch.pipeline"""
