"""Where the BVH tier's time goes on the card.

    python -m mitsuba2_tpu_torch.tools.prof_bvh

For bench.py's big-mesh scenes, biggeo (``bumpy_sphere_dict`` with
nu=512, nv=257) and hero (``hero_serialized_dict``), at 256x256, 32 spp,
on one CUDA device:

- depth: the path kernel at max_depth 1, 2, 3 and 5: how time follows
  path length;
- walk: for camera rays in the kernel's lane order (a warp is 32 samples
  of one pixel), the box and face tests of each ray's walk
  (ops/intersect.py ``traverse``, the device walk step for step, over 256
  warps drawn at random from the image) and the share of a warp's lane slots
  that do work when its lanes walk in lock-step (mean over max, per warp);
- leaf: the traversal tree rebuilt at 2, 4, 8 and 16 faces per leaf (the
  builder may keep up to four times as many where splitting costs more):
  the tree's pair nodes and depth, the path kernel at max_depth 5 and the
  intersection kernel's closest hit on the 2,097,152 camera rays;
- profile: ``torch.profiler`` over 5 back-to-back renders of each scene:
  device time by kernel and the device's busy share of the span from its
  first to its last kernel.

Kernel times are CUDA-event medians of 5 after a warm-up. Prints the
card's name and power limit first. Exits non-zero without a CUDA device.
"""

import subprocess
import sys
import tempfile

import torch

from ..core.profiler import device_op_summary, kernel_ms, trace

WIDTH, SPP, MAX_DEPTH, SEED = 256, 32, 5, 7
WARPS = 256


def scenes():
    from ..python.test.scenes import bumpy_sphere_dict, hero_serialized_dict
    return {"biggeo": lambda depth: bumpy_sphere_dict(
                WIDTH, WIDTH, SPP, depth, 512, 257),
            "hero": lambda depth: hero_serialized_dict(
                WIDTH, WIDTH, SPP, depth)}


def path_ms(pk, scene, tables, max_depth):
    cam = pk.camera_row(scene.sensors[0], scene.device)
    return kernel_ms(lambda: pk.path_radiance(
        tables, cam, 0, 0, SPP, WIDTH, WIDTH, max_depth,
        scene.integrator.rr_depth))


def walk(pk, isx, scene, tables):
    """Per-ray box and face tests of the camera rays of WARPS warps, and
    the lock-step share of lane slots."""
    cam = pk.camera_row(scene.sensors[0], scene.device)
    o, d = pk.camera_rays(cam, WIDTH, WIDTH, SPP, SEED)
    g = torch.Generator(device=o.device).manual_seed(SEED)
    warps = torch.randperm(o.shape[0] // 32, generator=g,
                           device=o.device)[:WARPS]
    idx = (warps[:, None] * 32 + torch.arange(32, device=o.device)).ravel()
    n = len(idx)
    w = isx.traverse(tables.bvh_nodes, tables.bvh_woop, tables.bvh_prim,
                     o[idx], d[idx], torch.zeros(n, device=o.device),
                     torch.full((n,), 3.0e38, device=o.device))
    out = []
    for part in ("boxes", "faces"):
        c = w[part].float().reshape(-1, 32)
        out.append((float(c.mean()),
                    float(c.sum() / (32 * c.max(dim=1).values.sum()))))
    return out


def with_leaf(pk, bvh, scene, leaf):
    """The scene's tables with the traversal tree rebuilt at ``leaf``."""
    tree = bvh.build_bvh(scene.v0, scene.e1, scene.e2, leaf_size=leaf)
    nodes, depth = bvh.pack_traversal(tree)
    tables = scene.tables
    order = torch.as_tensor(tree.order, device=tables.device)
    return tables._replace(
        bvh_nodes=torch.as_tensor(nodes, device=tables.device),
        bvh_woop=pk.face_woop(tables)[order.long()].contiguous(),
        bvh_prim=order.to(torch.int32), bvh_depth=depth)


def profile(scene, label):
    integ = scene.integrator
    for _ in range(3):
        integ.render(scene, seed=0, spp=SPP)
    torch.cuda.synchronize()
    log_dir = tempfile.mkdtemp(prefix="prof_bvh_")
    with trace(log_dir):
        for i in range(5):
            integ.render(scene, seed=i, spp=SPP)
    print(f"{label} profile, 5 renders: "
          + device_op_summary(log_dir, top=4))


def main():
    if not torch.cuda.is_available():
        print("prof_bvh: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    import mitsuba2_tpu_torch as mi
    from ..ops import build, bvh, intersect as isx
    from ..ops import intersect_kernel as ik, path_kernel as pk
    mi.set_variant("scalar_rgb")
    build.build_all(pk.libraries()[:1] + ik.libraries() + [("bvh", {})])
    for label, make in scenes().items():
        scene = mi.load_dict(make(MAX_DEPTH))
        tables = scene.tables
        print(f"{label}: {tables.n_faces} faces, "
              f"{tables.bvh_nodes.shape[0]} pair nodes, depth "
              f"{tables.bvh_depth}")
        for depth in (1, 2, 3, 5):
            print(f"  depth {depth}: path kernel "
                  f"{path_ms(pk, scene, tables, depth):.3f} ms")
        (boxes, box_share), (faces, face_share) = walk(pk, isx, scene,
                                                       tables)
        print(f"  camera-ray walk: {boxes:.2f} box tests ({box_share:.4f} "
              f"of lane slots busy in lock-step), {faces:.2f} face tests "
              f"({face_share:.4f})")
        cam = pk.camera_row(scene.sensors[0], scene.device)
        o, d = pk.camera_rays(cam, WIDTH, WIDTH, SPP, SEED)
        n = o.shape[0]
        rays = (o, d, torch.zeros(n, device=o.device),
                torch.full((n,), float("inf"), device=o.device))
        for leaf in (2, 4, 8, 16):
            t = with_leaf(pk, bvh, scene, leaf)
            print(f"  leaf {leaf:2d}: {t.bvh_nodes.shape[0]} pair nodes, "
                  f"depth {t.bvh_depth}; path kernel "
                  f"{path_ms(pk, scene, t, MAX_DEPTH):.3f} ms; closest hit "
                  f"on {n} camera rays "
                  f"{kernel_ms(lambda: ik.isect_closest(t, *rays)):.4f} ms")
        profile(scene, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
