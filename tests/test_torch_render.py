"""The port's device splat (fvp_torch/ops/heatmap_render.py) on the CPU
against the reference package's `render_heatmaps_device` (XLA) and
against the numpy renderer (data/heatmaps.py::generate_input_heatmap),
clean and augmented, within 1e-5, with leading (B, V) dims; and the
synthetic dataset's render parameters rendered by the port against the
same dataset's host-rendered heatmaps."""

import dataclasses

import numpy as np
import pytest
import torch

import fvp_torch.config as tcfg
from fvp_torch.ops.heatmap_render import render_heatmaps_device
from fvp_tpu.data.heatmaps import generate_input_heatmap
from fvp_tpu.ops.heatmap_render import \
    render_heatmaps_device as jax_render
from tests.helpers import tiny_config
from tests.test_device_render import _pack

ATOL = 1e-5


def _views(rng, cfg, augment, B=2, V=3):
    """(B, V) views of random people (some joints invisible, some off the
    image): the packed render parameters (B, V, ...) and the numpy
    renderer's heatmaps (B, V, J, h, w) of the same draws."""
    J, P = cfg.num_joints, cfg.max_people
    hm_w, hm_h = cfg.heatmap_size
    packs, refs = [], []
    for _ in range(B * V):
        n = rng.randint(1, P + 1)
        joints = [np.stack([rng.uniform(-80, cfg.image_size[0] + 80, J),
                            rng.uniform(-80, cfg.image_size[1] + 80, J)], 1)
                  for _ in range(n)]
        vis = [(rng.rand(J) > 0.2).astype(np.float64) for _ in range(n)]
        scale = occ = None
        if augment:
            scale = np.ones((P, J), np.float32)
            occ = np.zeros((P, J, 4), np.int32)
            for p in range(n):
                for j in range(J):
                    scale[p, j] = 0.5 + 0.5 * rng.rand()
                    y0, x0 = rng.randint(0, hm_h - 1), rng.randint(0, hm_w - 1)
                    occ[p, j] = (y0, min(y0 + rng.randint(4, hm_h), hm_h),
                                 x0, min(x0 + rng.randint(4, hm_w), hm_w))
        packs.append(_pack(cfg, joints, vis, scale, occ))
        refs.append(generate_input_heatmap(
            cfg, joints, joints_vis=vis, augment=augment,
            draws=(scale, occ) if augment else None))
    params = [np.stack([p[i] for p in packs]).reshape(
        B, V, *packs[0][i].shape) for i in range(5)]
    ref = np.stack(refs).reshape(B, V, *refs[0].shape)
    return params, ref


@pytest.mark.parametrize("augment", [False, True],
                         ids=["clean", "augmented"])
def test_render_matches_reference_and_numpy(rng, augment):
    cfg = tiny_config(sigma=3.0, heatmap_size=(120, 64))
    params, ref = _views(rng, cfg, augment)
    got = render_heatmaps_device(
        tcfg.FVPConfig(**dataclasses.asdict(cfg)),
        *(torch.from_numpy(a) for a in params))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert ref.max() > 0.5                      # non-vacuous
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    xla = np.asarray(jax_render(cfg, *params))
    np.testing.assert_allclose(got.numpy(), xla, rtol=0, atol=ATOL)


@pytest.mark.parametrize("augment", [False, True],
                         ids=["clean", "augmented"])
def test_dataset_render_params_match_host_render(augment):
    """A synthetic sample's render parameters, splatted by the port, give
    that sample's host-rendered heatmaps (the same RNG draws on both
    paths: the augmentation comes with the parameters)."""
    from fvp_torch.data.registry import build_dataset

    base = tcfg.FVPConfig(num_views=3, heatmap_size=(120, 64),
                          synthetic_num_data=3, synthetic_max_people=3,
                          synthetic_augmentation=augment,
                          test_heatmap_src="gt")
    ds_dev = build_dataset("synthetic", base.replace(device_render=True),
                           is_train=False)
    ds_host = build_dataset("synthetic", base, is_train=False)
    for i in range(len(ds_dev)):
        rp = ds_dev.sample(i, rng=np.random.RandomState(i))["render_params"]
        got = render_heatmaps_device(
            base, *(torch.from_numpy(rp[k])
                    for k in ("mu", "vis", "sigma", "scale", "occ")))
        if augment:
            # the host renderer draws its own augmentation; render the
            # packed draws with the numpy renderer instead
            ref = _host_from_params(ds_dev, i, rp)
        else:
            ref = ds_host.sample(i, rng=np.random.RandomState(i))[
                "input_heatmaps"]
        assert ref.max() > 0.5
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


def _host_from_params(ds, i, rp):
    """The numpy renderer on sample i's projected views with the packed
    augmentation draws."""
    from fvp_torch.data.heatmaps import \
        generate_input_heatmap as port_generate
    views_2d, views_vis = ds._project_gt_views(ds.records[i])
    return np.stack([
        port_generate(ds.cfg, j2d, joints_vis=jv, augment=True,
                      draws=(rp["scale"][v], rp["occ"][v]))
        for v, (j2d, jv) in enumerate(zip(views_2d, views_vis))])
