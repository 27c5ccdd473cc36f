"""The port's Teuchos-XML loader (``isph_tpu_torch/config_xml.py``) against
the JAX package's, on decks written here: the reference's sph-script XML is
not in the repository.  The full deck sets every sublist the loader parses
(Kernel Function, Physics Configuration, Incompressible Navier Stokes,
Poisson Boltzmann, Applied Electric Field, Surface Tension, Solute
Transport, Particle Information); the bare one leaves every default to the
loader.  Configs compare field by field, kind maps exactly."""

import dataclasses

import pytest

from isph_tpu import config_xml as jconfig_xml

from isph_tpu_torch import config_xml, interop

FULL = """<ParameterList name="Implicit SPH">
  <Parameter name="Description" type="string" value="a deck of every sublist"/>
  <ParameterList name="Kernel Function">
    <Parameter name="type" type="string" value="Quintic"/>
    <Parameter name="cut over h" type="double" value="3.0"/>
  </ParameterList>
  <ParameterList name="Physics Configuration">
    <Parameter name="Incompressible Navier Stokes" type="string" value="Enabled"/>
    <Parameter name="Poisson Boltzmann" type="string" value="Enabled"/>
    <Parameter name="Applied Electric Field" type="string" value="Enabled"/>
    <Parameter name="Surface Tension" type="string" value="Enabled"/>
    <Parameter name="Solute Transport" type="string" value="Enabled"/>
  </ParameterList>
  <ParameterList name="Incompressible Navier Stokes">
    <Parameter name="theta" type="double" value="1.0"/>
    <Parameter name="Singular Poisson" type="string" value="PinZero"/>
    <Parameter name="Boundary" type="string" value="MorrisHolmes"/>
    <Parameter name="beta" type="double" value="0.25"/>
    <Parameter name="g.x" type="double" value="0.5"/>
    <Parameter name="g.y" type="double" value="-9.8"/>
    <Parameter name="g.z" type="double" value="0.125"/>
    <Parameter name="Use Incremental Pressure" type="string" value="Disabled"/>
    <Parameter name="Use Momentum Preserve Operator" type="string" value="Disabled"/>
    <Parameter name="Verbose" type="bool" value="true"/>
  </ParameterList>
  <ParameterList name="Poisson Boltzmann">
    <Parameter name="ezcb" type="double" value="38.9"/>
    <Parameter name="psiref" type="double" value="0.0257"/>
    <Parameter name="gamma" type="double" value="2.5"/>
    <Parameter name="linearized" type="int" value="1"/>
  </ParameterList>
  <ParameterList name="Applied Electric Field">
    <Parameter name="e.x" type="double" value="1.5"/>
    <Parameter name="e.y" type="double" value="-0.5"/>
    <Parameter name="e.z" type="double" value="0.0"/>
  </ParameterList>
  <ParameterList name="Surface Tension">
    <Parameter name="alpha" type="double" value="0.026"/>
    <Parameter name="kappa max" type="double" value="1.0e4"/>
    <Parameter name="theta" type="double" value="1.0472"/>
  </ParameterList>
  <ParameterList name="Solute Transport">
    <Parameter name="theta" type="double" value="0.75"/>
    <Parameter name="d:1" type="double" value="1.0e-3"/>
    <Parameter name="d:3" type="double" value="2.5e-4"/>
  </ParameterList>
  <ParameterList name="Particle Information">
    <Parameter name="type:1" type="string" value="fluid"/>
    <Parameter name="type:2" type="string" value="solid:fixed"/>
    <Parameter name="type:3" type="string" value="Boundary"/>
    <Parameter name="type:4" type="string" value="fluid:phase:1"/>
    <Parameter name="type:5" type="string" value="BufferDirichlet"/>
    <Parameter name="type:6" type="string" value="bufferneumann"/>
    <Parameter name="type:7" type="string" value="colloid"/>
    <Parameter name="note" type="string" value="not a type entry"/>
  </ParameterList>
</ParameterList>
"""

BARE = """<ParameterList name="Implicit SPH">
  <ParameterList name="Kernel Function">
    <Parameter name="type" type="string" value="cubic"/>
  </ParameterList>
  <ParameterList name="Surface Tension">
    <Parameter name="kappa" type="double" value="250.0"/>
  </ParameterList>
</ParameterList>
"""


@pytest.mark.parametrize("deck, kw", [
    (FULL, dict(h=0.05, dim=3, dt=2.5e-4, dtype="float32")),
    (BARE, dict(h=0.1)),
], ids=["every-sublist", "defaults"])
def test_load_xml_config_matches_jax(tmp_path, deck, kw):
    path = tmp_path / "deck.xml"
    path.write_text(deck)
    cfg, kinds = config_xml.load_xml_config(str(path), **kw)
    jcfg, jkinds = jconfig_xml.load_xml_config(str(path), **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        interop.config_from_dict(dataclasses.asdict(jcfg)))
    assert kinds == {int(k): int(v) for k, v in jkinds.items()}
    if deck is FULL:
        assert cfg.kernel.type.value == "Quintic" and cfg.pb.is_linearized
        assert cfg.tr.d == (1.0e-3, None, 2.5e-4, None)
        assert (cfg.ns.enabled, cfg.pb.enabled, cfg.ae.enabled, cfg.st.enabled,
                cfg.tr.enabled) == (True,) * 5
        assert len(kinds) == 7
    else:
        assert cfg.st.kappa_max == 250.0 and not cfg.ns.enabled and kinds == {}


def test_particle_information_matches_jax():
    pinfo = {"type:1": "fluid", "type:2": "Solid:fixed", "type:3": "boundary",
             "type:9": "bufferNeumann", "type:4": "unknown", "other": "fluid"}
    assert config_xml.parse_particle_information(pinfo) == {
        int(k): int(v) for k, v in jconfig_xml.parse_particle_information(pinfo).items()}
