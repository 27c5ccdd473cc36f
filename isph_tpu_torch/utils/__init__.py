from isph_tpu_torch.utils import dense, packed, profiling, time_bdf
