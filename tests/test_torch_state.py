"""PyTorch port vs JAX: one P-frame step started from carried state.

The JAX package encodes an I frame (its recon becomes the reference),
runs HME on the next frame pair and steps the stability accumulators
from a non-trivial carried state; the port gets the same state through
`state_from_numpy` and must produce the same stable-block map,
accumulators, quantized planes, DCs and recon image."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dsv1_tpu.constants import SUBSAMP_420, quality_percent
from dsv1_tpu.models import encoder as jenc
from dsv1_tpu.ops import hme as jhme
from dsv1_tpu.parallel import gop as jgop
from dsv1_tpu_torch import state_from_numpy
from dsv1_tpu_torch.models import encoder as tenc
from dsv1_tpu_torch.parallel import gop as tgop

from . import corpus

torch.set_num_threads(1)


def test_p_step_from_carried_state():
    w, h, levels, sr = 96, 80, 3, 5
    blk_w, blk_h, nbh, nbv = jgop.block_geometry(w, h)
    nblk = nbh * nbv
    frames = corpus.make_clip_frames(w, h, SUBSAMP_420, 2, seed=21)
    quant = jgop.crf_quant(quality_percent(85))
    prep = jenc.make_prep(SUBSAMP_420, w, h, levels)
    layouts = list(jenc._pyr_layouts(SUBSAMP_420, w, h, levels))
    imgs = [prep(tuple(jnp.asarray(p) for p in f))[0] for f in frames]
    core = jax.jit(jenc.make_encode_core_traced(SUBSAMP_420, w, h, blk_w,
                                                blk_h, nbh, nbv))
    z = jnp.zeros(nblk, jnp.int32)
    _, _, recon0 = core(imgs[0][0], imgs[0][0], jnp.bool_(False), quant,
                        jnp.ones(nblk, jnp.uint8), z, z, z, z)
    mv = jhme.hme(list(imgs[1]), list(imgs[0]), layouts, blk_w, blk_h, nbh,
                  nbv, SUBSAMP_420, levels)
    rng = np.random.default_rng(5)
    stab0 = rng.integers(-40, 40, (nblk, 2)).astype(np.int32)
    ctr0 = 2
    jstab, jctr, jstable = jgop._stable_update(
        jnp.asarray(stab0), jnp.int32(ctr0), jnp.bool_(True), mv, sr)
    margs = [mv[k].reshape(-1) for k in ("mode", "mvx", "mvy", "submask")]
    jq, jdc, jrec = core(imgs[1][0], recon0, jnp.bool_(True), quant, jstable,
                         *margs)

    st = state_from_numpy(stab0, ctr0, 0, np.asarray(recon0), "cpu")
    tmv = {k: torch.from_numpy(np.array(mv[k])) for k in tgop.MV_KEYS}
    stab, ctr, stable = tgop._stable_update(st.stability, st.refresh_ctr,
                                            True, tmv, sr)
    np.testing.assert_array_equal(stab.numpy(), np.asarray(jstab))
    assert ctr == int(jctr)
    np.testing.assert_array_equal(stable.numpy(), np.asarray(jstable))
    tcore = tenc.make_encode_core_traced(SUBSAMP_420, w, h, blk_w, blk_h,
                                         nbh, nbv)
    tq, tdc, trec = tcore(torch.from_numpy(np.array(imgs[1][0])),
                          st.ref_recon, True, quant, stable,
                          *[tmv[k] for k in ("mode", "mvx", "mvy",
                                             "submask")])
    for a, b in zip(tq, jq):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert [int(d) for d in tdc] == [int(d) for d in jdc]
    np.testing.assert_array_equal(trec.numpy(), np.asarray(jrec))
