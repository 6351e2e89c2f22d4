"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  This file imports neither JAX nor `laghos_tpu`, so it also runs
on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Without a CUDA card every test skips.
"""

import numpy as np
import pytest
import torch

from laghos_tpu_torch.fem import mesh as tmesh
from laghos_tpu_torch.hydro import Hydro, Options
from laghos_tpu_torch.ops import qphys
from laghos_tpu_torch.ops import qupdate as tqup
from laghos_tpu_torch.ops import tensor as ttensor


@pytest.fixture(scope="module")
def qdata():
    """3D q-data on the card: the Sedov mesh refined once, its state
    perturbed by a numpy-seeded field, with inverted and NaN points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m = tmesh.uniform_refine(tmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0)))
    h = Hydro(m, Options(problem=1), device="cuda")
    rng = np.random.default_rng(0)
    S = h.S0
    v = S["v"] + torch.tensor(0.1 * rng.normal(size=tuple(S["v"].shape)),
                              dtype=h.dtype, device=h.device)
    t = h.tables
    J9 = tqup._grad9(h._gather_e(S["x"]), t["H1B"], t["H1G"], h.nd1, h.NQ)
    dV9 = tqup._grad9(h._gather_e(v), t["H1B"], t["H1G"], h.nd1, h.NQ)
    et = S["e"].reshape((h.NE,) + (h.l1d,) * 3)
    e_q = ttensor.eval_values(et, t["L2B"], 3).reshape(h.NE, h.NQ) + 0.5
    J9[:, 3, 5] *= -1.0              # detJ < 0
    J9[:, 10, 0] *= -1.0
    J9[4, 20, 7] = float("nan")      # NaN geometry
    e_q[30, 11] = float("nan")       # NaN energy
    return h, [J9.contiguous(), dV9.contiguous(), h.Jac0inv_t,
               e_q.contiguous(), h.rho0DetJ0w_t, h.gamma_t, t["Winv"]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("visc,vort", [(True, False), (True, True),
                                       (False, False)])
def test_qphys_kernel_matches_plain(qdata, dtype, tol, visc, vort):
    h, inputs = qdata
    args = [a.to(dtype) for a in inputs]
    kw = dict(h0_e=h.h0, h1order=2.0, cfl=0.5, use_viscosity=visc,
              use_vorticity=vort)
    before = qphys.physics_3d.launches
    s_k, d_k = qphys.physics_3d(*args, **kw)
    torch.cuda.synchronize()
    assert qphys.physics_3d.launches == before + 1
    s_p, d_p = qphys.physics_3d_plain(*args, **kw)
    assert torch.equal(torch.isnan(s_k), torch.isnan(s_p))
    assert torch.equal(d_k == 0, d_p == 0)
    assert int((d_p == 0).sum()) == 4
    fin = ~torch.isnan(s_p)
    scale = float(s_p[fin].abs().max())
    assert float((s_k[fin] - s_p[fin]).abs().max()) <= tol * scale
    good = d_p > 0
    dmin = float(d_p[good].min())
    assert abs(float(d_k[good].min()) - dmin) <= tol * dmin


@pytest.mark.cuda
def test_qphys_kernel_refuses_bad_inputs(qdata):
    h, inputs = qdata
    kw = dict(h0_e=h.h0, h1order=2.0, cfl=0.5)
    with pytest.raises(TypeError):
        qphys.physics_3d(*[a.cpu() if i == 4 else a
                           for i, a in enumerate(inputs)], **kw)
    with pytest.raises(ValueError):
        qphys.physics_3d(inputs[0][:, :, ::2], *inputs[1:], **kw)
