from isph_tpu_torch.models import channel, driver, edl, geometry, tgv
