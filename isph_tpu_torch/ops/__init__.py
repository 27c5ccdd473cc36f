from isph_tpu_torch.ops import corrected, ell, kernels, mls, neighbors
