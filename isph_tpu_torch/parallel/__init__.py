from isph_tpu_torch.parallel import dist, mesh
