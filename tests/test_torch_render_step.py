"""One render step of the port from a JAX state captured after three
steps and carried over through interop: hit ids exact, Russian roulette
equal on >= 99.9% of slots, outputs within 1e-4 where it agrees."""

import jax.numpy as jnp
import numpy as np
import torch

from tyrant_tpu import render as jr
from tyrant_tpu import sky as jsky
from tyrant_tpu.config import small_config
from tyrant_tpu_torch import interop
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch import sky as tsky

from .test_torch_render import SUN, _jax_camera, _jax_scene


def _jax_state_after(cfg, jd, camd, sun, steps):
    st = jr.init_state(cfg)
    for _ in range(steps):
        st = jr.render_step(st, jd, camd, sun, cfg=cfg)
    return st


def _state_numpy(st):
    return {k: np.array(getattr(st, k)) for k in interop.STATE_FIELDS}


def test_one_step_from_captured_state():
    cfg = small_config(width=32, height=32, num_rays=4096)
    jd, td, tables = _jax_scene()
    camd, camt = _jax_camera(cfg)
    jsun = jsky.sun_direction_from_position(jnp.asarray(SUN))
    tsun = tsky.sun_direction_from_position(SUN, "cpu")
    sky_j, sky_t = jsky.SkyParams(cfg.sky), tsky.SkyParams(cfg.sky)
    st = _jax_state_after(cfg, jd, camd, jsun, 3)
    fields = _state_numpy(st)
    assert 0 < fields["n_carried"] < cfg.num_rays

    # the merged queue, built from the JAX state by the JAX raygen
    gen = jr._raygen(cfg, camd, st.start_position, st.frame, cfg.height, 0)
    keep = np.arange(cfg.num_rays) >= cfg.num_rays - fields["n_carried"]
    rays = {k: np.where(keep[:, None] if fields[k].ndim == 2 else keep,
                        fields[k], np.asarray(gen[k]))
            for k in ("origin", "direction", "direct", "pending", "pixel",
                      "bounces", "last_specular")}
    jrays = {k: jnp.asarray(v) for k, v in rays.items()}
    trays = {k: torch.from_numpy(np.array(v)) for k, v in rays.items()}

    # the port's queue merge from the carried state builds the same queue
    tq = tr.merge_queue(cfg, interop.state_from_numpy(fields, "cpu"), camt)
    for k, v in rays.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(tq[k].numpy(), v, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(tq[k].numpy(), v)

    # extend: hit ids exact
    jt, jid, jtri, _ = jr._intersect_scene(jrays["origin"], jrays["direction"],
                                           jd)
    tt, tid, ttri = tr._intersect_scene(trays["origin"], trays["direction"],
                                        td, tables)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(ttri.numpy(), np.asarray(jtri))
    hit = np.asarray(jt) < 1e20
    close = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit], **close)

    # shade from identical inputs: survive on >= 99.9% of slots, outputs
    # within 1e-4 where it agrees
    frame = fields["frame"]
    jc, _, jsurv, jnext, jshadow = jr._shade(
        cfg, jd, sky_j, jsun, jrays, jt, jid, jtri, jnp.uint32(frame))
    tc, tsurv, tnext, tshadow = tr._shade(
        cfg, td, sky_t, tsun, trays, torch.from_numpy(np.array(jt)),
        torch.from_numpy(np.array(jid)), torch.from_numpy(np.array(jtri)),
        torch.tensor(int(frame)))
    agree = tsurv.numpy() == np.asarray(jsurv)
    assert agree.mean() >= 0.999, agree.mean()
    ok = agree & (tshadow["valid"].numpy() == np.asarray(jshadow["valid"]))
    assert ok.mean() >= 0.999
    np.testing.assert_allclose(tc.numpy()[ok], np.asarray(jc)[ok], **close)
    for k in ("origin", "direction", "direct"):
        np.testing.assert_allclose(tnext[k].numpy()[ok],
                                   np.asarray(jnext[k])[ok], **close)
    for k in ("origin", "direction", "color"):
        np.testing.assert_allclose(tshadow[k].numpy()[ok],
                                   np.asarray(jshadow[k])[ok], **close)

    # connect on the same shadow queue
    jsh = {k: jnp.asarray(v) for k, v in jshadow.items()}
    tsh = {k: torch.from_numpy(np.array(v)) for k, v in jshadow.items()
           if k != "pixel"}
    np.testing.assert_allclose(tr._connect(td, tsh, tables).numpy(),
                               np.asarray(jr._connect(jd, jsh)), **close)

    # the whole step from the carried state
    jst = jr.render_step(st, jd, camd, jsun, cfg=cfg)
    tst = tr.render_step(interop.state_from_numpy(fields, "cpu"), td, camt,
                         tsun, cfg=cfg, tables=tables)
    n_bad = int((~agree).sum())
    assert abs(int(tst.n_carried) - int(jst.n_carried)) <= n_bad
    assert int(tst.shadow_rays) == int(jst.shadow_rays) + \
        int(tshadow["valid"].sum()) - int(np.asarray(jshadow["valid"]).sum())
    ja, ta = np.asarray(jst.accum), tst.accum.numpy()
    bad_pix = np.unique(rays["pixel"][~ok])
    good = np.ones(ja.shape[0], bool)
    good[bad_pix] = False
    np.testing.assert_array_equal(ta[good, 3], ja[good, 3])
    np.testing.assert_allclose(ta[good], ja[good], **close)
