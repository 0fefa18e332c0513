"""PyTorch port, MDR QoI and decomposed MDR on the CPU: the counterparts of
tests/test_qoi.py's two MDR tests and of tests/test_mdr.py's decomposed
tests, and JAX-written variables reconstructed through the port's QoI
pipeline with the JAX package's joint plan. Every check is a bound: the
certified QoI bound and the true QoI error stay within qoi_tol (1e-12 of
float64 slack where a bound is compared with itself); decomposed
reconstructions meet their L-inf or RMS tolerance.
"""

import numpy as np
import pytest
import torch

from mgard_tpu import Config as JConfig
from mgard_tpu import mdr as JM
from mgard_tpu.mdr import api as JA
from mgard_tpu.mdr import qoi as JQ
import mgard_tpu_torch as M
from mgard_tpu_torch import mdr as TM
from mgard_tpu_torch.mdr import api as TA
from mgard_tpu_torch.mdr.components import estimate_error
from mgard_tpu_torch.mdr.qoi import MDReconstructQoI, VTotQoI, \
    plan_joint_retrieval

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

CPU = "cpu"
SHAPE = (33, 33)


def smooth(shape, seed=0):
    """tests/test_qoi.py's field."""
    rng = np.random.default_rng(seed)
    axes = [np.linspace(0, 1, n) for n in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    v = np.zeros(shape)
    for _ in range(3):
        ks = rng.integers(1, 4, len(shape))
        acc = rng.uniform(0, 2 * np.pi)
        for k, g in zip(ks, grids):
            acc = acc + 2 * np.pi * k * g
        v += rng.uniform(0.3, 1.0) * np.sin(acc)
    return v


def _plan_bytes(metas, plan):
    """Bytes a joint plan fetches from scratch."""
    total = 0
    for m, c in zip(metas, plan):
        m.prev_used = []
        total += TM.retrieve_size(m, c)
    return total


def _refactor_vars(seed0):
    cfg = M.Config()
    cfg.total_num_bitplanes = 12
    vs = [smooth(SHAPE, seed=seed0 + i) + 1.5 for i in range(3)]
    pairs = [TM.MDRefactor(v, cfg, device=CPU) for v in vs]
    return vs, [p[0] for p in pairs], [p[1] for p in pairs]


def test_mdr_vtot_qoi():
    vars_true, metas, datas = _refactor_vars(0)
    qoi = VTotQoI()
    vtot_true = qoi.eval([torch.from_numpy(v) for v in vars_true])
    tol = 1e-2
    vars_rec, vtot_rec, bound, counts = MDReconstructQoI(metas, datas, tol,
                                                         qoi, device=CPU)
    assert bound <= tol
    assert all(r.device.type == "cpu" for r in vars_rec)
    actual = float((vtot_true - vtot_rec).abs().max())
    assert actual <= tol
    assert any(c < 12 for counts_v in counts for c in counts_v)


def test_mdr_qoi_device_check_survives_corrupted_tables():
    """The acceptance bound is evaluated on the reconstructed fields, so
    50x inflated tables still end with a bound the true error respects."""
    vars_true, metas, datas = _refactor_vars(10)
    qoi = VTotQoI()
    vtot_true = qoi.eval([torch.from_numpy(v) for v in vars_true])
    tol = 1e-2
    vars_rec, vtot_rec, bound, counts = MDReconstructQoI(metas, datas, tol,
                                                         qoi, device=CPU)
    assert bound <= tol
    per_var = [estimate_error(m, c, np.inf) for m, c in zip(metas, counts)]
    assert bound <= qoi.bound(per_var) + 1e-12
    assert float((vtot_true - vtot_rec).abs().max()) <= bound + 1e-12
    for m in metas:
        for lm in m.levels:
            lm.err_max = lm.err_max * 50.0
            lm.err_sq = lm.err_sq * 2500.0
    vars_rec, vtot_rec, bound, counts = MDReconstructQoI(metas, datas, tol,
                                                         qoi, device=CPU)
    assert float((vtot_true - vtot_rec).abs().max()) <= bound + 1e-12
    assert all(c <= 12 for cv in counts for c in cv)


def test_jax_variables_through_the_port_qoi():
    """Variables refactored by the JAX package: the port's joint plan meets
    the QoI bound with no more bytes than the JAX package's (the planners
    diverge on purpose, ROADMAP queue 3: the port ranks steps of several
    planes), and the port's QoI reconstruction certifies it."""
    jcfg = JConfig()
    jcfg.total_num_bitplanes = 12
    vs = [smooth(SHAPE, seed=20 + i) + 1.5 for i in range(3)]
    jpairs = [JM.MDRefactor(v, jcfg) for v in vs]
    blobs = [m.serialize() for m, _ in jpairs]
    tmetas = [TA.RefactoredMetadata.deserialize(b)[0] for b in blobs]
    jmetas = [JA.RefactoredMetadata.deserialize(b)[0] for b in blobs]
    tol = 1e-2
    plan = plan_joint_retrieval(tmetas, tol)
    jplan = JQ.plan_joint_retrieval(jmetas, tol)
    for p in (plan, jplan):
        assert VTotQoI().bound([estimate_error(m, c, np.inf)
                                for m, c in zip(tmetas, p)]) <= tol
    assert _plan_bytes(tmetas, plan) <= _plan_bytes(tmetas, jplan)
    datas = [TA.RefactoredData(d.planes) for _, d in jpairs]
    vars_rec, vtot_rec, bound, _ = MDReconstructQoI(tmetas, datas, tol,
                                                    device=CPU)
    truth = VTotQoI().eval([torch.from_numpy(v) for v in vs])
    assert bound <= tol and float((truth - vtot_rec).abs().max()) <= tol
    # the data-dependent bound of the two packages on the same fields
    per_var = [0.004, 0.003, 0.002]
    fields = [r.numpy() for r in vars_rec]
    assert abs(VTotQoI().device_bound(vars_rec, per_var)
               - JQ.VTotQoI().device_bound(fields, per_var)) <= 1e-12


def _decomposed(seed):
    v = np.random.default_rng(seed).standard_normal((24, 9, 9))
    cfg = M.Config()
    cfg.domain_decomposition = M.domain_decomposition_type.Block
    cfg.block_size = 9
    return v.astype(np.float32), cfg


def test_decomposed_mdr():
    v, cfg = _decomposed(9)
    dmdr = TM.MDRefactorDecomposed(v, cfg, device=CPU)
    assert len(dmdr.metas) > 1
    plans = TM.MDRequestDecomposed(dmdr, 1e-2)
    out = TM.MDReconstructDecomposed(dmdr, plans, cfg, device=CPU)
    assert out.dtype == torch.float32 and tuple(out.shape) == v.shape
    assert float((out - torch.from_numpy(v)).abs().max()) <= 1e-2
    # each subdomain's stream reconstructs in the JAX package too, on the
    # port's plan, which costs no more bytes than the JAX planner's
    for m, d, sl, c in zip(dmdr.metas, dmdr.datas, dmdr.subdomain_slices,
                           plans):
        jm, _ = JA.RefactoredMetadata.deserialize(m.serialize())
        assert _plan_bytes([m], [c]) <= _plan_bytes([m],
                                                    [JM.MDRequest(jm, 1e-2)])
        rec = JM.MDReconstruct(jm, JA.RefactoredData(d.planes), c).data
        assert float(np.max(np.abs(rec - v[sl]))) <= 1e-2


def test_decomposed_finite_s_rms_bound():
    v, cfg = _decomposed(12)
    dmdr = TM.MDRefactorDecomposed(torch.from_numpy(v), cfg)
    assert len(dmdr.metas) > 1
    tol = 1e-2
    plans = TM.MDRequestDecomposed(dmdr, tol, s=0.0)
    out = TM.MDReconstructDecomposed(dmdr, plans, cfg, device=CPU)
    rms = float(np.sqrt(np.mean((out.numpy().astype(np.float64) - v) ** 2)))
    assert rms <= tol
    for m, c in zip(dmdr.metas, plans):
        assert estimate_error(m, c, 0.0) <= tol


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_device_bound_on_tensors(dtype):
    """VTotQoI on tensors: V_TOT and the data-dependent bound in float64."""
    rng = np.random.default_rng(4)
    vs = [torch.from_numpy(rng.standard_normal((5, 7)).astype(dtype))
          for _ in range(3)]
    q = VTotQoI()
    want = np.sqrt(sum(v.numpy().astype(np.float64) ** 2 for v in vs))
    np.testing.assert_allclose(q.eval(vs).numpy(), want, rtol=1e-15)
    assert q.eval(vs).dtype == torch.float64
    b = q.device_bound(vs, [1e-3, 2e-3, 0.0])
    assert b == pytest.approx(JQ.VTotQoI().device_bound(
        [v.numpy() for v in vs], [1e-3, 2e-3, 0.0]), rel=1e-12)
