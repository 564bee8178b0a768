"""The wavefronts' images of one checkout, saved or held bit for bit
against another checkout's.

    python mitsuba2_tpu_torch/tools/wavefront_images.py --save FILE
        [--device cuda|cpu]
    python mitsuba2_tpu_torch/tools/wavefront_images.py --compare FILE
        [--device cuda|cpu]

Renders the path wavefront (the Cornell box forced off the path kernel
with ``_disable_kernel``, cornell_surfaces, cornell_lights) and the
volpath wavefront (the volpath slab under ``volpath`` and ``volpathmis``,
forced off the volumetric kernel, and fog_spot) at 16x16, 4 spp, seed 3,
in the rgb, spectral and mono variants, with the fixtures' independent
sampler. ``--save`` writes the 18 images to FILE; ``--compare`` holds each
against FILE's and prints whether it is bit-identical, exiting non-zero
if any differs. It imports the package ``mitsuba2_tpu_torch`` from the
Python path, so that run as a file with ``PYTHONPATH`` set to another
checkout it renders that checkout's images (a change that must leave the
wavefronts' sample streams and arithmetic as they were: save with the
parent, compare with the change).
"""

import argparse
import sys

import torch

VARIANTS = ("scalar_rgb", "scalar_spectral", "scalar_mono")


def scenes():
    """(name, fixture call) of each image, the fixtures of
    python/test/scenes.py at 16x16, 4 spp."""
    from mitsuba2_tpu_torch.python.test import scenes as S

    def slab(integrator):
        d = S.volpath_slab_dict(16, 16, 4, 8)
        d["integrator"]["type"] = integrator
        return d

    return (("cornell", lambda: S.cornell_box_dict(16, 16, 4, 6)),
            ("surfaces", lambda: S.cornell_surfaces_dict(16, 16, 4, 6)),
            ("lights", lambda: S.cornell_lights_dict(16, 16, 4, 6)),
            ("slab volpath", lambda: slab("volpath")),
            ("slab volpathmis", lambda: slab("volpathmis")),
            ("fog_spot", lambda: S.fog_spot_dict(16, 16, 4, 6)))


def render_all(device):
    """{"variant scene": image on the CPU} of every scene in every
    variant, each rendered on ``device`` through its wavefront."""
    import mitsuba2_tpu_torch as mt
    mt.set_device(device)
    out = {}
    for variant in VARIANTS:
        mt.set_variant(variant)
        for name, make in scenes():
            scene = mt.load_dict(make())
            scene.integrator._disable_kernel = True
            img = scene.integrator.render(scene, seed=3, spp=4)
            if scene.integrator.last_engine != "wavefront":
                raise SystemExit(f"{variant} {name}: engine "
                                 f"{scene.integrator.last_engine}")
            out[f"{variant} {name}"] = img.cpu()
    mt.set_variant("scalar_rgb")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save", default="")
    ap.add_argument("--compare", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if bool(args.save) == bool(args.compare):
        ap.error("give one of --save and --compare")
    images = render_all(args.device)
    if args.save:
        torch.save(images, args.save)
        print(f"saved {len(images)} images to {args.save}")
        return 0
    saved = torch.load(args.compare)
    same = {k: k in saved and torch.equal(images[k], saved[k])
            for k in images}
    for k, ok in same.items():
        print(f"{k}: bit-identical {ok}")
    print(f"{sum(same.values())} of {len(same)} images bit-identical to "
          f"{args.compare}")
    return 0 if all(same.values()) and len(saved) == len(same) else 1


if __name__ == "__main__":
    sys.exit(main())
