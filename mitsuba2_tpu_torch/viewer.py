"""Image viewer (the role of mtsgui, src/mtsgui and libui/viewer.cpp: an
EXR viewer with exposure control and layer tabs; ``mitsuba2_tpu.viewer``):
headless, it tonemaps a rendered image to PNG, writes a standalone HTML
viewer with exposure, gamma and layer controls in the page, or serves that
page on localhost.

Usage:
    python -m mitsuba2_tpu_torch.viewer out.exr -o preview.png --exposure 1.5
    python -m mitsuba2_tpu_torch.viewer out.exr --html view.html
    python -m mitsuba2_tpu_torch.viewer out.exr --serve --port 8000
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os

import numpy as np


def tonemap(img: np.ndarray, exposure: float = 0.0,
            gamma: bool = True) -> np.ndarray:
    out = np.asarray(img, np.float32)[..., :3] * (2.0 ** exposure)
    if gamma:
        from .utils.io_image import linear_to_srgb
        out = linear_to_srgb(np.clip(out, 0.0, 1.0))
    return np.clip(out, 0.0, 1.0)


def _load(path):
    from .utils.io_exr import read_exr
    from .utils.io_image import read_image
    names = None
    if path.lower().endswith(".exr"):
        img, names = read_exr(path)
    else:
        img = read_image(path)
    return np.asarray(img, np.float32), names


def _layers(img, names):
    """Split a multichannel image into named 3-channel layers (the viewer's
    layer tabs; AOV channel groups like S1.r/S1.g/S1.b become one tab)."""
    c = img.shape[-1]
    if c <= 4 or not names:
        return {"rgb": img[..., :3]}
    layers = {"rgb": img[..., :3]}
    groups = {}
    for i, nm in enumerate(names):
        key = nm.rsplit(".", 1)[0] if "." in nm else nm
        groups.setdefault(key, []).append(i)
    for key, idx in groups.items():
        if key.lower() in ("r", "g", "b") or len(idx) > 3:
            continue
        sel = img[..., idx]
        if sel.shape[-1] == 1:
            sel = np.repeat(sel, 3, -1)
        elif sel.shape[-1] == 2:
            sel = np.concatenate([sel, sel[..., :1]], -1)
        layers[key] = sel[..., :3]
    return layers


_HTML = """<!doctype html><meta charset="utf-8"><title>mitsuba2_tpu viewer</title>
<style>body{background:#222;color:#ddd;font:13px sans-serif;margin:12px}
canvas{image-rendering:pixelated;border:1px solid #555}
label{margin-right:14px}</style>
<div>
 <label>layer <select id="layer"></select></label>
 <label>exposure <input id="exp" type="range" min="-8" max="8" step="0.1"
  value="0"> <span id="expv">0.0</span></label>
 <label><input id="gamma" type="checkbox" checked> sRGB</label>
 <span id="pix"></span>
</div>
<canvas id="cv"></canvas>
<script>
// payload: gzipped float16 pixel planes, base64-embedded (vs the raw-JSON
// float text this replaces: ~20-40x smaller)
const META = __META__;
const B64 = "__B64__";
function f16(u) {  // IEEE half -> number
  const s = (u & 0x8000) ? -1 : 1, e = (u >> 10) & 0x1f, m = u & 0x3ff;
  if (e === 0) return s * m * Math.pow(2, -24);
  if (e === 31) return m ? NaN : s * Infinity;
  return s * (1024 + m) * Math.pow(2, e - 25);
}
async function inflate(b64) {
  const raw = Uint8Array.from(atob(b64), c => c.charCodeAt(0));
  const ds = new DecompressionStream('gzip');
  const out = await new Response(
    new Blob([raw]).stream().pipeThrough(ds)).arrayBuffer();
  return new Uint16Array(out);
}
const DATA = {shape: META.shape, layers: {}};
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
const sel = document.getElementById('layer');
for (const k of Object.keys(META.layers)) {
  const o = document.createElement('option'); o.textContent = k;
  sel.appendChild(o); }
function draw() {
  const layer = DATA.layers[sel.value];
  const exp = parseFloat(document.getElementById('exp').value);
  document.getElementById('expv').textContent = exp.toFixed(1);
  const g = document.getElementById('gamma').checked;
  const [h, w] = DATA.shape; cv.width = w; cv.height = h;
  const im = ctx.createImageData(w, h); const s = Math.pow(2, exp);
  for (let i = 0; i < w*h; i++) {
    for (let c = 0; c < 3; c++) {
      let v = layer[i*3+c] * s;
      v = Math.min(Math.max(v, 0), 1);
      if (g) v = v <= 0.0031308 ? v*12.92 : 1.055*Math.pow(v,1/2.4)-0.055;
      im.data[i*4+c] = Math.round(v*255); }
    im.data[i*4+3] = 255; }
  ctx.putImageData(im, 0, 0); }
sel.onchange = draw;
document.getElementById('exp').oninput = draw;
document.getElementById('gamma').onchange = draw;
cv.onmousemove = e => {
  const x = Math.floor(e.offsetX), y = Math.floor(e.offsetY);
  const layer = DATA.layers[sel.value]; const i = (y*DATA.shape[1]+x)*3;
  document.getElementById('pix').textContent =
    `(${x},${y}) = ${layer[i]?.toFixed(4)} ${layer[i+1]?.toFixed(4)} ` +
    `${layer[i+2]?.toFixed(4)}`; };
inflate(B64).then(u16 => {
  for (const [k, [off, len]] of Object.entries(META.layers)) {
    const a = new Float32Array(len);
    for (let i = 0; i < len; i++) a[i] = f16(u16[off + i]);
    DATA.layers[k] = a; }
  draw(); });
</script>"""


def make_html(img: np.ndarray, names=None) -> str:
    """The standalone viewer page of ``img``: its layers as gzipped
    float16 planes in base64 (a zero gzip time stamp, so that one image
    gives one page)."""
    import gzip
    planes, meta, off = [], {}, 0
    for k, v in _layers(img, names).items():
        flat = np.asarray(v, np.float16).reshape(-1)
        meta[k] = [off, flat.size]
        planes.append(flat)
        off += flat.size
    blob = gzip.compress(np.concatenate(planes).tobytes(), 6, mtime=0)
    payload = {"shape": list(img.shape[:2]), "layers": meta}
    return (_HTML.replace("__META__", json.dumps(payload))
            .replace("__B64__", base64.b64encode(blob).decode()))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mitsuba2_tpu_torch.viewer",
        description="headless render viewer (role of mtsgui)")
    ap.add_argument("image")
    ap.add_argument("-o", "--output", help="write tonemapped PNG here")
    ap.add_argument("--exposure", type=float, default=0.0)
    ap.add_argument("--no-gamma", action="store_true")
    ap.add_argument("--serve", action="store_true",
                    help="serve an interactive HTML viewer")
    ap.add_argument("--port", type=int, default=8631)
    ap.add_argument("--html", help="write the HTML viewer to a file")
    args = ap.parse_args(argv)

    img, names = _load(args.image)
    if args.output:
        from PIL import Image
        mapped = tonemap(img, args.exposure, not args.no_gamma)
        Image.fromarray(
            (np.clip(mapped, 0, 1) * 255 + 0.5).astype(np.uint8)
        ).save(args.output)
        print(f"wrote {args.output}")
    if args.html:
        with open(args.html, "w") as f:
            f.write(make_html(img, names))
        print(f"wrote {args.html}")
    if args.serve:
        import http.server
        html = make_html(img, names).encode()

        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(html)

            def log_message(self, *a):
                pass

        print(f"serving on http://127.0.0.1:{args.port}")
        http.server.HTTPServer(("127.0.0.1", args.port), H).serve_forever()
    if not (args.output or args.serve or args.html):
        # print image stats like the CLI exit summary
        print(f"{args.image}: {img.shape[1]}x{img.shape[0]} "
              f"x{img.shape[-1]}ch  min {img.min():.4f}  "
              f"mean {img.mean():.4f}  max {img.max():.4f}")


if __name__ == "__main__":
    main()
