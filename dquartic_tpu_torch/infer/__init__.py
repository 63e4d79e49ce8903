from .sampler import DDIMSampler

__all__ = ["DDIMSampler"]
