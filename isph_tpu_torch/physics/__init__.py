from isph_tpu_torch.physics import (
    ale,
    bonds,
    diagnostics,
    electrokinetics,
    fluctuation,
    multiphase,
    ns_projection,
    qeq,
    shift,
    status,
    transport,
)
