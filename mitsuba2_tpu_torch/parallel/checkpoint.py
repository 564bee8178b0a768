"""Checkpoint and resume for long renders and inverse-rendering runs
(mitsuba2_tpu/parallel/checkpoint.py, written with ``torch.save`` and
``torch.load`` in place of orbax; the file format is this package's own).

The reference has no counterpart beyond its SIGHUP partial-image develop:
here a render's accumulated image block and an optimizer's state persist
across preemptions. Files are written beside their path and renamed over
it, so a run cut while writing leaves the last checkpoint whole.
"""

from __future__ import annotations

import os

import torch


def _save(path, payload):
    path = os.path.abspath(path)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _load(path):
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def save_film_state(path: str, data, pass_index: int,
                    meta: dict | None = None):
    """Persist a render's accumulated image block ``data`` (the sum of its
    passes' blocks, weights last) after ``pass_index`` passes."""
    _save(path, {"data": data.detach().cpu(), "pass_index": int(pass_index),
                 "meta": dict(meta or {})})


def load_film_state(path: str, expect_meta: dict | None = None,
                    device=None):
    """-> (image block data, pass index). Every key of ``expect_meta``
    must equal the checkpoint's: resuming after a change of spp,
    resolution, channels or seed would mis-weight the film."""
    payload = _load(path)
    stored = payload.get("meta") or {}
    for k, v in (expect_meta or {}).items():
        if k not in stored:
            raise ValueError(
                f"checkpoint {path} has no '{k}' in its meta; refusing to "
                f"resume (expected {v!r})")
        if stored[k] != v:
            raise ValueError(
                f"checkpoint {path} was written with {k}={stored[k]!r}, but "
                f"this render uses {k}={v!r}; delete the checkpoint or "
                f"restore the original settings")
    data = payload["data"]
    if device is not None:
        data = data.to(device)
    return data, int(payload["pass_index"])


def save_optimizer(path: str, optimizer):
    """Persist an optimizer's state (python/autodiff.py ``SGD`` or
    ``Adam``: its moments and step count) and its parameter values."""
    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        return x.detach().cpu() if isinstance(x, torch.Tensor) else x
    _save(path, host(optimizer.state_dict()))


def load_optimizer(path: str, optimizer):
    """Restore ``save_optimizer``'s file into ``optimizer`` (its values on
    the parameters' device, written into the scene) -> the optimizer."""
    optimizer.load_state_dict(_load(path))
    return optimizer


def render_with_checkpoints(scene, sensor=0, seed=0, spp=None,
                            checkpoint_path=None, checkpoint_every=4):
    """A resumable render: the passes of ``integrator.render``'s split,
    the accumulated block checkpointed every ``checkpoint_every`` passes
    and after the last; a checkpoint at ``checkpoint_path`` written by the
    same settings is resumed from. -> the developed image."""
    from ..render.film import ImageBlock
    if isinstance(sensor, int):
        sensor = scene.sensors[sensor]
    integrator = scene.integrator
    sampler = sensor.sampler
    film = sensor.film
    w, h = film.crop_size
    if spp is None:
        spp = sampler.sample_count
    cap = integrator.wavefront_cap(scene, sensor)
    spp_per_pass = max(1, min(spp, cap // (w * h)))
    while spp % spp_per_pass:
        spp_per_pass -= 1
    n_passes = spp // spp_per_pass
    n_aovs = len(integrator.aov_names())
    block = ImageBlock((w, h), 3 + n_aovs, film.rfilter, scene.device)
    data = block.create()
    start = 0
    run_meta = {"spp": spp, "spp_per_pass": spp_per_pass, "crop_w": w,
                "crop_h": h, "n_aovs": n_aovs, "seed": seed}
    if checkpoint_path and os.path.exists(checkpoint_path):
        data, start = load_film_state(checkpoint_path, expect_meta=run_meta,
                                      device=scene.device)
    for p in range(start, n_passes):
        data = data + integrator.render_wavefront(
            scene, sensor, sampler, seed, p * spp_per_pass, spp_per_pass,
            spp)
        if checkpoint_path and ((p + 1) % checkpoint_every == 0
                                or p + 1 == n_passes):
            save_film_state(checkpoint_path, data, p + 1, meta=run_meta)
    return block.develop(data)
