"""Teuchos-XML compatibility loader (PyTorch port of
``isph_tpu/config_xml.py``; it reads only ``xml`` and the port's config).

Parses the reference's ParameterList XML decks (sph-script/*.xml; schema
documented in sph-script/example.xml, parsed by the reference in
pair_isph.cpp:1424-1881) into :class:`isph_tpu_torch.config.SimulationConfig`,
so existing problem decks configure the port directly.

Supported sublists: Kernel Function, Physics Configuration, Incompressible
Navier Stokes, Poisson Boltzmann, Applied Electric Field, Surface Tension,
Solute Transport, Particle Information (returned as a type->kind map).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, Tuple

from isph_tpu_torch import config as C
from isph_tpu_torch.state import Kind


def _plist(elem) -> dict:
    """ParameterList element -> nested dict."""
    out = {}
    for child in elem:
        name = child.attrib.get("name", "")
        if child.tag == "ParameterList":
            out[name] = _plist(child)
        elif child.tag == "Parameter":
            t = child.attrib.get("type", "string")
            v = child.attrib.get("value", "")
            if t == "double":
                out[name] = float(v)
            elif t == "int":
                out[name] = int(v)
            elif t == "bool":
                out[name] = v.lower() in ("true", "1")
            else:
                out[name] = v
    return out


_KIND_MAP = {
    "fluid": Kind.FLUID_BIT,
    "solid": Kind.SOLID,
    "boundary": Kind.BOUNDARY,
    "bufferdirichlet": Kind.BUFFER_DIRICHLET,
    "bufferneumann": Kind.BUFFER_NEUMANN,
}


def parse_particle_information(pinfo: dict) -> Dict[int, int]:
    """"type:N" -> "fluid[:phase:P]" / "solid[:fixed]" entries
    (pair_isph.cpp:1461-1539) -> {lammps_type: kind_bitmask}; an unknown
    base kind reads as fluid, as in the JAX package."""
    out = {}
    for key, val in pinfo.items():
        if not key.startswith("type:"):
            continue
        tid = int(key.split(":")[1])
        base = str(val).split(":")[0].strip().lower()
        out[tid] = _KIND_MAP.get(base, Kind.FLUID_BIT)
    return out


def load_xml_config(
    path: str,
    *,
    h: float,
    dim: int = 2,
    dt: float = 1.0e-3,
    dtype: str = "float64",
) -> Tuple[C.SimulationConfig, Dict[int, int]]:
    """Load a reference XML deck.  ``h`` comes from the pair_coeff command in
    the .lmp script (the XML never carries it), as in
    ``pair_coeff * * deck.xml h``."""
    top = _plist(ET.parse(path).getroot())

    kern = top.get("Kernel Function", {})
    ktype = {"wendland": C.KernelType.WENDLAND, "cubic": C.KernelType.CUBIC,
             "quintic": C.KernelType.QUINTIC}[str(kern.get("type", "Wendland")).lower()]
    kernel = C.KernelConfig(type=ktype, cut_over_h=float(kern.get("cut over h", 2.0)))

    phys = top.get("Physics Configuration", {})

    def enabled(key):
        return str(phys.get(key, "Disabled")) == "Enabled"

    nsl = top.get("Incompressible Navier Stokes", {})
    ns = C.NavierStokesConfig(
        enabled=enabled("Incompressible Navier Stokes"),
        theta=float(nsl.get("theta", 0.5)),
        singular_poisson=C.SingularPoisson(nsl.get("Singular Poisson", "NullSpace")),
        boundary=C.BoundaryCond(nsl.get("Boundary", "NoBoundaryCond")),
        beta=float(nsl.get("beta", 0.0)),
        g=(float(nsl.get("g.x", 0.0)), float(nsl.get("g.y", 0.0)), float(nsl.get("g.z", 0.0))),
        use_incremental_pressure=(nsl.get("Use Incremental Pressure", "Enabled") == "Enabled"),
        use_momentum_preserve_operator=(
            nsl.get("Use Momentum Preserve Operator", "Enabled") == "Enabled"),
    )

    pbl = top.get("Poisson Boltzmann", {})
    pb = C.PoissonBoltzmannConfig(
        enabled=enabled("Poisson Boltzmann"),
        ezcb=float(pbl.get("ezcb", 1.0)),
        psiref=float(pbl.get("psiref", 1.0)),
        gamma=float(pbl.get("gamma", 0.0)),
        is_linearized=bool(int(pbl.get("linearized", 0))),
    )

    ael = top.get("Applied Electric Field", {})
    ae = C.AppliedElectricFieldConfig(
        enabled=enabled("Applied Electric Field"),
        e=(float(ael.get("e.x", 0.0)), float(ael.get("e.y", 0.0)), float(ael.get("e.z", 0.0))),
    )

    stl = top.get("Surface Tension", {})
    st = C.SurfaceTensionConfig(
        enabled=enabled("Surface Tension"),
        alpha=float(stl.get("alpha", 0.0)),
        kappa_max=float(stl.get("kappa max", stl.get("kappa", 0.0)) or 0.0),
        theta=float(stl.get("theta", 0.0)),
    )

    trl = top.get("Solute Transport", {})
    dvals = []
    for i in range(4):
        v = trl.get(f"d:{i + 1}", None)
        dvals.append(float(v) if v is not None else None)
    tr = C.SoluteTransportConfig(
        enabled=enabled("Solute Transport"),
        theta=float(trl.get("theta", 0.5)),
        d=tuple(dvals),
    )

    cfg = C.SimulationConfig(
        dim=dim, h=h, dt=dt, dtype=dtype,
        kernel=kernel, ns=ns, pb=pb, ae=ae, st=st, tr=tr,
    )
    kinds = parse_particle_information(top.get("Particle Information", {}))
    return cfg, kinds
