"""PyTorch port, host layer: enums, header bytes, hierarchy tables, config
interop, and the import boundary (the port never imports JAX or the JAX
package)."""

import dataclasses
import enum
import re
from pathlib import Path

import numpy as np
import pytest

import mgard_tpu
import mgard_tpu.dtypes as jdt
import mgard_tpu_torch
import mgard_tpu_torch.dtypes as tdt
from mgard_tpu.formats.metadata import Metadata as JMeta
from mgard_tpu.hierarchy import get_hierarchy as j_hier
from mgard_tpu_torch.decomposer import DomainDecomposer, calc_local_abs_tol
from mgard_tpu_torch.formats.metadata import FormatError, Metadata as TMeta
from mgard_tpu_torch.hierarchy import get_hierarchy as t_hier
from mgard_tpu_torch.interop import config_from_jax
from mgard_tpu_torch.utils.bytesink import Fill, join

_ENUMS = sorted(n for n, o in vars(jdt).items()
                if isinstance(o, type) and issubclass(o, enum.IntEnum)
                and o is not enum.IntEnum)


@pytest.mark.parametrize("name", _ENUMS)
def test_enum_values_equal(name):
    j, t = getattr(jdt, name), getattr(tdt, name)
    assert [(m.name, int(m)) for m in j] == [(m.name, int(m)) for m in t]


_META_CASES = [
    dict(),
    dict(shape=(64, 64, 128), decomposition=2, l_target=4, tol=1e-3,
         ltype=10, nlocal=3, hybrid_grouping=True),
    dict(shape=(40, 33), ebtype=0, norm=3.5, tol=1e-2, s=0.0, ntype=1,
         domain_decomposed=True, ddtype=2, domain_decomposed_dim=1,
         domain_decomposed_size=20, dd_variable_sizes=(13, 20), adjusted=True),
    dict(shape=(5, 6), dstype=1, coords=[np.linspace(0, 1, 5),
                                        np.arange(6.0) ** 2], dtype=1,
         demoted=True, roi_enabled=True, roi_factor=16.0),
]


def _meta(cls, mod, fields):
    """Build a Metadata of package `mod` with enum fields by value."""
    m = cls()
    for k, v in fields.items():
        default = getattr(m, k)
        if isinstance(default, enum.Enum):
            v = type(default)(v)
        setattr(m, k, v)
    return m


@pytest.mark.parametrize("case", range(len(_META_CASES)))
def test_metadata_bytes_identical(case):
    f = _META_CASES[case]
    jb = _meta(JMeta, jdt, f).serialize()
    tb = _meta(TMeta, tdt, f).serialize()
    assert jb == tb
    back, size = TMeta.deserialize(tb + b"payload")
    assert size == len(tb) and back.serialize() == tb


def test_metadata_crc_rejects_corruption():
    b = bytearray(TMeta(shape=(8, 8)).serialize())
    b[-1] ^= 1
    with pytest.raises(FormatError):
        TMeta.deserialize(bytes(b))


@pytest.mark.parametrize("shape", [(16, 16, 32), (32, 32, 32),
                                   (128, 128, 128)])
def test_hierarchy_tables_equal(shape):
    j = j_hier(shape, np.float32)
    t = t_hier(shape, np.float32)
    assert j.l_target == t.l_target
    assert j.level_shape == t.level_shape
    for aj, at in zip(j.axis, t.axis):
        for a, b in zip(aj, at):
            for f in dataclasses.fields(a):
                np.testing.assert_array_equal(getattr(a, f.name),
                                              getattr(b, f.name))
    np.testing.assert_array_equal(j.quantizers(1e-3, np.inf, 0.0, jdt.
                                               error_bound_type.ABS),
                                  t.quantizers(1e-3, np.inf, 0.0, tdt.
                                               error_bound_type.ABS))


def _asdict_by_value(cfg):
    return {k: (int(v) if isinstance(v, enum.Enum) else v)
            for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("knobs", [
    {},
    dict(bfp_chunk=8, bfp_sb_blocks=8192, bfp_base_planes=5,
         bfp_resid_planes=7, num_local_refactoring_level=2,
         hybrid_level_grouping=False, domain_decomposition_sizes=[3, 4]),
    dict(hybrid_fused_pack=True, bfp_base_planes=6),
])
def test_config_from_jax_roundtrip(knobs):
    jc = mgard_tpu.Config(**knobs)
    tc = config_from_jax(dataclasses.asdict(jc))
    assert isinstance(tc, mgard_tpu_torch.Config)
    assert _asdict_by_value(tc) == _asdict_by_value(jc)
    assert type(tc.lossless) is tdt.lossless_type


def test_config_from_jax_rejects_unknown_field():
    with pytest.raises(ValueError):
        config_from_jax({"not_a_field": 1})


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|mgard_tpu)(\.|\s|$)",
                     re.MULTILINE)


def test_port_never_imports_jax_or_the_jax_package():
    root = Path(mgard_tpu_torch.__file__).parent
    files = sorted(root.rglob("*.py"))
    assert len(files) >= 20
    offenders = [str(p) for p in files if _IMPORT.search(p.read_text())]
    assert not offenders, offenders


def test_port_exports_every_name_of_the_jax_package():
    """The same API: every name in mgard_tpu.__all__ (and the two the JAX
    package serves lazily, calculate_norm and compress_roi) is exported by
    the port and resolves."""
    want = set(mgard_tpu.__all__) | {"calculate_norm", "compress_roi"}
    assert want <= set(mgard_tpu_torch.__all__), \
        want - set(mgard_tpu_torch.__all__)
    for name in mgard_tpu_torch.__all__:
        assert getattr(mgard_tpu_torch, name) is not None, name
    assert mgard_tpu_torch.get_hierarchy((9, 17), np.float32).shape == (9, 17)
    assert isinstance(mgard_tpu_torch.get_hierarchy((9,), np.float64),
                      mgard_tpu_torch.Hierarchy)
    v = np.linspace(-2.0, 1.0, 50)
    assert mgard_tpu_torch.calculate_norm(v, np.inf, False) == 2.0


def test_decomposer_cpu_default_and_local_tol():
    cfg = mgard_tpu_torch.Config()
    dd = DomainDecomposer((512, 512, 512), np.float32, cfg, device="cpu")
    assert dd.num_subdomains == 1
    cfg.max_memory_footprint = 1 << 20
    dd2 = DomainDecomposer((64, 64, 128), np.float32, cfg, device="cpu")
    assert dd2.num_subdomains > 1 and dd2.domain_decomposed
    assert calc_local_abs_tol(tdt.error_bound_type.REL, 2.0, 1e-3, np.inf,
                              4) == pytest.approx(2e-3)


def test_bytesink_join_fills():
    parts = [b"ab", np.arange(3, dtype="<u4"),
             Fill(4, lambda d: d.__setitem__(slice(None), 7))]
    assert join(parts) == (b"ab" + np.arange(3, dtype="<u4").tobytes()
                           + bytes([7] * 4))
