"""The port's all-atom geometry (``lam_slide_tpu_torch/geometry``) against the
JAX package's and against the reference golden, on the CPU.

* Every ported op (atom14 <-> atom37, backbone frames, torsions, the torsion
  -> frames -> atom14/37 forward kinematics, Rigid's algebra and quaternion
  helpers) against JAX's on random frames, torsions and aatypes made with
  numpy from a seed: fp32 on both sides, only the order of fp32 sums
  differs, within 1e-5 (absolute; positions are O(10) Å, unit vectors O(1)).
* The golden of the reference torch pipeline (tests/golden/geometry_golden.npz):
  the forward kinematics, conversions, torsions and frames within 1e-5
  (tests/test_geometry.py allows 2e-4 there, for tables that could differ
  from the reference's by that much; these agree closer).
* Gradients of the two loss transforms, ``frame_aligned_positions`` and
  ``peptide_torsions``, against ``jax.grad`` of the same scalar (within
  1e-4 relative to the largest grad: the backward sums in another order),
  including a glycine (undefined chi) whose cosine loss goes through
  ``safe_norm`` and must give a finite, JAX-equal gradient.
* The copied tables and the protein PDB IO equal JAX's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.composites import peptide as jpep
from lam_slide_tpu.geometry import constants as jpc
from lam_slide_tpu.geometry import ops as jops
from lam_slide_tpu.geometry import protein as jprot
from lam_slide_tpu.geometry import rigid as jrigid
from lam_slide_tpu_torch.composites import peptide as tpep
from lam_slide_tpu_torch.geometry import constants as tpc
from lam_slide_tpu_torch.geometry import ops as tops
from lam_slide_tpu_torch.geometry import protein as tprot
from lam_slide_tpu_torch.geometry import rigid as trigid

ATOL = 1e-5
GRAD_RTOL = 1e-4
GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "golden", "geometry_golden.npz"))


def _n(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _random_chain(seed, batch=(3,), n_res=5):
    """Backbone rotations, translations, torsions (sin/cos) and aatypes."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((*batch, n_res, 4)).astype(np.float32)
    rots = np.asarray(jrigid.quat_to_rot(jnp.asarray(q)))
    trans = (rng.standard_normal((*batch, n_res, 3)) * 3).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (*batch, n_res, 7))
    tors = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    aatype = rng.integers(0, 20, (*batch, n_res))
    return rots, trans, tors, aatype


def _fk_both(seed):
    rots, trans, tors, aatype = _random_chain(seed)
    j = jops.frames_torsions_to_atom14(jrigid.Rigid(jnp.asarray(rots), jnp.asarray(trans)),
                                       jnp.asarray(tors), jnp.asarray(aatype))
    t = tops.frames_torsions_to_atom14(trigid.Rigid(torch.from_numpy(rots),
                                                    torch.from_numpy(trans)),
                                       torch.from_numpy(tors), torch.from_numpy(aatype))
    return np.asarray(j), _n(t), aatype


def test_tables_equal_jax():
    for name in dir(jpc):
        value = getattr(jpc, name)
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(getattr(tpc, name), value, err_msg=name)
    assert tpc.ATOM_ORDER == jpc.ATOM_ORDER and tpc.RESNAMES == jpc.RESNAMES


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_kinematics_matches_jax(seed):
    want, got, _ = _fk_both(seed)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("seed", [2, 3])
def test_atom_conversions_and_torsions_match_jax(seed):
    a14, _, aatype = _fk_both(seed)
    a37_j = jops.atom14_to_atom37(jnp.asarray(a14), jnp.asarray(aatype))
    a37_t = tops.atom14_to_atom37(torch.from_numpy(a14), torch.from_numpy(aatype))
    np.testing.assert_allclose(_n(a37_t), np.asarray(a37_j), atol=ATOL)
    back_j = jops.atom37_to_atom14(a37_j, jnp.asarray(aatype))
    back_t = tops.atom37_to_atom14(a37_t, torch.from_numpy(aatype))
    np.testing.assert_allclose(_n(back_t), np.asarray(back_j), atol=ATOL)
    # with masks
    m14 = (np.random.default_rng(seed).random(a14.shape[:-1]) > 0.2).astype(np.float32)
    (_, mj), (_, mt) = (jops.atom14_to_atom37(jnp.asarray(a14), jnp.asarray(aatype),
                                              jnp.asarray(m14)),
                        tops.atom14_to_atom37(torch.from_numpy(a14), torch.from_numpy(aatype),
                                              torch.from_numpy(m14)))
    np.testing.assert_array_equal(_n(mt), np.asarray(mj))
    (_, mj), (_, mt) = (jops.atom37_to_atom14(a37_j, jnp.asarray(aatype), mj),
                        tops.atom37_to_atom14(a37_t, torch.from_numpy(aatype), mt))
    np.testing.assert_array_equal(_n(mt), np.asarray(mj))
    tj, tmj = jops.atom37_to_torsions(a37_j, jnp.asarray(aatype))
    tt, tmt = tops.atom37_to_torsions(a37_t, torch.from_numpy(aatype))
    np.testing.assert_array_equal(_n(tmt), np.asarray(tmj))
    np.testing.assert_allclose(_n(tt), np.asarray(tj), atol=ATOL)
    fj, ft = jops.atom14_to_frames(jnp.asarray(a14)), tops.atom14_to_frames(torch.from_numpy(a14))
    np.testing.assert_allclose(_n(ft.rots), np.asarray(fj.rots), atol=ATOL)
    np.testing.assert_allclose(_n(ft.trans), np.asarray(fj.trans), atol=ATOL)
    a37f_j = jops.frames_torsions_to_atom37(fj, tj, jnp.asarray(aatype))
    a37f_t = tops.frames_torsions_to_atom37(ft, tt, torch.from_numpy(aatype))
    np.testing.assert_allclose(_n(a37f_t), np.asarray(a37f_j), atol=ATOL)


def test_numpy_inputs_give_cpu_tensors():
    """The analysis modules call the ops on numpy arrays (float64 where
    numpy made them): fp32 CPU tensors come back, equal to the tensor call."""
    a14, _, aatype = _fk_both(4)
    got = tops.atom14_to_atom37(a14.astype(np.float64), aatype)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(got), _n(tops.atom14_to_atom37(
        torch.from_numpy(a14), torch.from_numpy(aatype))))


def test_golden_pipeline():
    aatype = torch.from_numpy(GOLDEN["aatype"])
    bb = trigid.Rigid(torch.from_numpy(GOLDEN["bb_rots"]), torch.from_numpy(GOLDEN["bb_trans"]))
    a14 = tops.frames_torsions_to_atom14(bb, torch.from_numpy(GOLDEN["torsions"]), aatype)
    np.testing.assert_allclose(_n(a14), GOLDEN["atom14"], atol=ATOL)
    a37 = tops.atom14_to_atom37(torch.from_numpy(GOLDEN["atom14"]), aatype)
    np.testing.assert_allclose(_n(a37), GOLDEN["atom37"], atol=ATOL)
    tors, mask = tops.atom37_to_torsions(torch.from_numpy(GOLDEN["atom37"]), aatype)
    np.testing.assert_allclose(_n(mask), GOLDEN["torsions_mask"], atol=ATOL)
    m = GOLDEN["torsions_mask"][..., None]
    np.testing.assert_allclose(_n(tors) * m, GOLDEN["torsions_out"] * m, atol=ATOL)
    frames = tops.atom14_to_frames(torch.from_numpy(GOLDEN["atom14"][None]))
    np.testing.assert_allclose(_n(frames.rots[0]), GOLDEN["frames_rots"], atol=ATOL)
    np.testing.assert_allclose(_n(frames.trans[0]), GOLDEN["frames_trans"], atol=ATOL)


def test_rigid_algebra_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 6, 4)).astype(np.float32)
    tr = rng.standard_normal((2, 6, 3)).astype(np.float32)
    pts = rng.standard_normal((2, 6, 3)).astype(np.float32)
    rj = jrigid.Rigid(jrigid.quat_to_rot(jnp.asarray(q)), jnp.asarray(tr))
    rt = trigid.Rigid(trigid.quat_to_rot(torch.from_numpy(q)), torch.from_numpy(tr))
    np.testing.assert_allclose(_n(rt.rots), np.asarray(rj.rots), atol=ATOL)
    other_j, other_t = rj[:, ::-1], rt[:, torch.arange(5, -1, -1)]
    for got, want in ((rt.apply(torch.from_numpy(pts)), rj.apply(jnp.asarray(pts))),
                      (rt.invert_apply(torch.from_numpy(pts)), rj.invert_apply(jnp.asarray(pts))),
                      (rt.compose(other_t).rots, rj.compose(other_j).rots),
                      (rt.compose(other_t).trans, rj.compose(other_j).trans),
                      (rt.invert().trans, rj.invert().trans),
                      (rt.to_tensor_4x4(), rj.to_tensor_4x4()),
                      (trigid.Rigid.cat([rt, rt], axis=-1).trans,
                       jrigid.Rigid.cat([rj, rj], axis=-1).trans),
                      (rt.unsqueeze(-1).rots, rj.unsqueeze(-1).rots),
                      (trigid.rot_to_quat(rt.rots), jrigid.rot_to_quat(rj.rots))):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_n(got), np.asarray(want), atol=1e-4 if got.shape[-1] == 4
                                   and got.dim() == 3 else ATOL)
    p = rng.standard_normal((7, 3, 3)).astype(np.float32) * 3
    fj = jrigid.Rigid.from_3_points(*(jnp.asarray(p[:, i]) for i in range(3)))
    ft = trigid.Rigid.from_3_points(*(torch.from_numpy(p[:, i]) for i in range(3)))
    np.testing.assert_allclose(_n(ft.rots), np.asarray(fj.rots), atol=ATOL)
    ident = trigid.Rigid.identity((3,))
    np.testing.assert_array_equal(_n(trigid.Rigid.from_tensor_4x4(ident.to_tensor_4x4()).rots),
                                  np.broadcast_to(np.eye(3), (3, 3, 3)))


def _grad_pair(fn_j, fn_t, pos, aatype, weights):
    """jax.grad and torch autograd of sum(weights * fn(pos)) w.r.t. pos."""
    gj = jax.grad(lambda p: jnp.sum(jnp.asarray(weights) * fn_j(p, jnp.asarray(aatype))))(
        jnp.asarray(pos))
    pt = torch.from_numpy(pos).requires_grad_(True)
    (torch.from_numpy(weights) * fn_t(pt, torch.from_numpy(aatype))).sum().backward()
    return pt.grad.numpy(), np.asarray(gj)


@pytest.mark.parametrize("glycine", [False, True])
def test_loss_transform_grads_match_jax(glycine):
    a14, _, aatype = _fk_both(6)
    if glycine:
        aatype = np.full_like(aatype, 7)  # GLY: no side chain, every chi undefined
    rng = np.random.default_rng(7)
    pos = (a14 + 0.1 * rng.standard_normal(a14.shape)).astype(np.float32)
    w_frame = rng.standard_normal(a14.shape).astype(np.float32)
    got, want = _grad_pair(lambda p, a: jpep.frame_aligned_positions(p),
                           lambda p, a: tpep.frame_aligned_positions(p), pos, aatype, w_frame)
    np.testing.assert_allclose(got, want, atol=GRAD_RTOL * np.abs(want).max())
    # weights on the defined torsions only: an undefined one (the first
    # residue's omega and phi, built on the zero padding) is a Gram-Schmidt
    # frame of a zero vector, whose gradient is rounding noise in both
    # packages; the losses mask it out
    _, mask = jops.atom37_to_torsions(jops.atom14_to_atom37(jnp.asarray(a14),
                                                            jnp.asarray(aatype)),
                                      jnp.asarray(aatype))
    w_tors = (rng.standard_normal((*aatype.shape, 7, 2))
              * np.asarray(mask)[..., None]).astype(np.float32)
    got, want = _grad_pair(jpep.peptide_torsions, tpep.peptide_torsions, pos, aatype, w_tors)
    np.testing.assert_allclose(got, want, atol=GRAD_RTOL * np.abs(want).max())

    # the cosine loss against a target whose undefined torsions are all-zero
    # vectors: safe_norm keeps the gradient finite, and equal to JAX's
    target = (np.asarray(jpep.peptide_torsions(jnp.asarray(a14), jnp.asarray(aatype)))
              * np.asarray(mask)[..., None]).astype(np.float32)
    mask = np.asarray(mask)

    def j_loss(p):
        pred = jpep.peptide_torsions(p, jnp.asarray(aatype)) * jnp.asarray(mask)[..., None]
        return jpep.masked_cosine_flat(pred.reshape(-1, 2), jnp.asarray(target).reshape(-1, 2),
                                       jnp.asarray(mask).reshape(-1))

    gj = np.asarray(jax.grad(j_loss)(jnp.asarray(pos)))
    pt = torch.from_numpy(pos).requires_grad_(True)
    m = torch.from_numpy(mask)
    pred = tpep.peptide_torsions(pt, torch.from_numpy(aatype)) * m[..., None]
    tpep.masked_cosine_flat(pred.reshape(-1, 2), torch.from_numpy(target).reshape(-1, 2),
                            m.reshape(-1)).backward()
    assert np.isfinite(pt.grad.numpy()).all() and np.isfinite(gj).all()
    np.testing.assert_allclose(pt.grad.numpy(), gj, atol=GRAD_RTOL * max(np.abs(gj).max(), 1e-6))


def test_protein_pdb_io_equals_jax(tmp_path):
    a14, _, aatype = _fk_both(8)
    traj, res = a14[0][None].repeat(3, 0), aatype[0]
    tprot.atom14_to_pdb(traj, res, str(tmp_path / "t.pdb"))
    jprot.atom14_to_pdb(traj, res, str(tmp_path / "j.pdb"))
    text = (tmp_path / "t.pdb").read_text()
    assert text == (tmp_path / "j.pdb").read_text()
    pj, pt = jprot.from_pdb_string(text), tprot.from_pdb_string(text)
    for field in ("atom_positions", "atom_mask", "aatype", "residue_index", "chain_index"):
        np.testing.assert_array_equal(getattr(pt, field), getattr(pj, field))
