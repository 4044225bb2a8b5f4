"""In-browser world viewer, a zero-dependency alternative to matplotlib.

Counterpart of `madrona_bots_tpu/viz/web.py`.
`python -m madrona_bots_tpu_torch.viz.web [--num_worlds N] [--port P]
[--device cpu]` serves a canvas page that polls the simulator as JSON and
draws agents (coloured by species, sized by health), food packages and the
selected agent's depth / semantic sensor strips, the panel the reference's
ImGui viewer draws (gfx.cpp:214-318). Arrow keys switch world / agent;
W/S/R/F/Space/B drive the selected agent as the reference's keyboard scheme
does (gfx.cpp:176-205), through `SimManager.set_action`. Each snapshot reads
one host copy of the shown world; the JSON equals the JAX package's for the
same seed.

Pure stdlib (http.server and JSON polling): no websockets, no npm, works over
a plain SSH port-forward.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from madrona_bots_tpu_torch.api.manager import SimManager
from madrona_bots_tpu_torch.device import resolve
from madrona_bots_tpu_torch.viz.render import selected_slot, world_to_host

_PAGE = """<!DOCTYPE html>
<html><head><title>madrona_bots_tpu_torch</title><style>
 body { background:#111; color:#ddd; font-family:monospace; margin:14px; }
 canvas { background:#1b1b24; border:1px solid #444; image-rendering:pixelated; }
 #hud { margin:6px 0; }
</style></head><body>
<div id="hud">loading…</div>
<canvas id="world" width="768" height="576"></canvas><br>
<canvas id="depth" width="768" height="24"></canvas><br>
<canvas id="sem" width="768" height="24"></canvas>
<div>arrows: world/agent &nbsp; W/S move &nbsp; R/F rotate &nbsp; space shoot &nbsp; B breed</div>
<script>
const SPECIES = ["#888", "#e5484d", "#46a758", "#3e7bfa", "#f5a623"];
let keys = {};
document.addEventListener("keydown", e => {
  keys[e.key.toLowerCase()] = true;
  if (["arrowup","arrowdown","arrowleft","arrowright"," "].includes(e.key.toLowerCase())) e.preventDefault();
});
async function tick() {
  const q = Object.keys(keys).join(","); keys = {};
  const r = await fetch("/step?keys=" + encodeURIComponent(q));
  const s = await r.json();
  const c = document.getElementById("world"), g = c.getContext("2d");
  const sx = c.width / s.lim[0], sy = c.height / s.lim[1];
  g.clearRect(0, 0, c.width, c.height);
  g.strokeStyle = "#333";
  for (let x = 0; x <= s.lim[0]; x += s.chunk) {
    g.beginPath(); g.moveTo(x*sx, 0); g.lineTo(x*sx, c.height); g.stroke(); }
  for (let y = 0; y <= s.lim[1]; y += s.chunk) {
    g.beginPath(); g.moveTo(0, y*sy); g.lineTo(c.width, y*sy); g.stroke(); }
  for (const f of s.food) {
    g.fillStyle = "#e9d94f";
    g.fillRect(f[0]*sx - 2, c.height - f[1]*sy - 2, 5, 5); }
  s.agents.forEach((a, i) => {
    const r0 = 2 + 4 * Math.min(1, a.health / 100);
    g.fillStyle = SPECIES[a.species] || "#888";
    g.beginPath();
    g.arc(a.x*sx, c.height - a.y*sy, r0, 0, 6.283); g.fill();
    g.strokeStyle = i === s.sel ? "#fff" : g.fillStyle;
    g.beginPath();
    g.moveTo(a.x*sx, c.height - a.y*sy);
    g.lineTo((a.x + 3*Math.cos(a.h))*sx, c.height - (a.y + 3*Math.sin(a.h))*sy);
    g.stroke();
    if (i === s.sel) { g.strokeStyle = "#fff"; g.beginPath();
      g.arc(a.x*sx, c.height - a.y*sy, r0 + 3, 0, 6.283); g.stroke(); }
  });
  drawStrip("depth", s.depth.map(v => [v, v, v]));
  drawStrip("sem", s.semantic.map(v => {
    const col = v < 0 ? "#000" : SPECIES[v] || "#888";
    return [parseInt(col.slice(1,3),16), parseInt(col.slice(3,5),16),
            parseInt(col.slice(5,7),16)]; }));
  document.getElementById("hud").textContent =
    `world ${s.world}  agent ${s.sel}  epoch ${s.step}  alive ${s.alive}` +
    `  health ${s.agents[s.sel] ? s.agents[s.sel].health : "-"}`;
  setTimeout(tick, 66);
}
function drawStrip(id, rgb) {
  const c = document.getElementById(id), g = c.getContext("2d");
  const w = c.width / rgb.length;
  rgb.forEach((p, i) => {
    g.fillStyle = `rgb(${p[0]},${p[1]},${p[2]})`;
    g.fillRect(i*w, 0, w+1, c.height); });
}
tick();
</script></body></html>"""


class WebViewer:
    """Owns a SimManager and serves its state; one simulator step per poll
    by default (the browser's ~15 Hz poll becomes the simulator's clock)."""

    def __init__(self, num_worlds: int = 4, seed: int = 0,
                 init_agents: int = 32, autostep: bool = True, device=None,
                 **mgr_kwargs):
        self.mgr = SimManager(0, num_worlds, seed, init_agents, device=device,
                              **mgr_kwargs)
        self.autostep = autostep
        self.world = 0
        self.agent = 0
        self.lock = threading.Lock()

    def _selected_slot(self, alive: np.ndarray) -> int:
        self.agent, slot = selected_slot(alive, self.agent)
        return slot

    def handle_keys(self, keys):
        cfg = self.mgr.cfg
        ks = set(k for k in keys if k)
        if "arrowup" in ks:
            self.world = min(cfg.num_worlds - 1, self.world + 1)
        if "arrowdown" in ks:
            self.world = max(0, self.world - 1)
        if "arrowright" in ks:
            self.agent += 1
        if "arrowleft" in ks:
            self.agent = max(0, self.agent - 1)
        act = dict(forward=int("w" in ks), backward=int("s" in ks),
                   rotate_left=int("r" in ks), rotate_right=int("f" in ks),
                   shoot=int(" " in ks or "space" in ks),
                   breed=int("b" in ks))
        if any(act.values()):
            self._selected_slot(self.mgr.state.alive[self.world].cpu().numpy())
            offset = self.mgr.agent_offset_for_world(self.world)
            sensor_idx = self.mgr.sensor_index_tensor().to_torch()
            self.mgr.set_action(int(sensor_idx[offset + self.agent, 0]), **act)

    def step_and_snapshot(self, keys=()):
        with self.lock:
            self.handle_keys(keys)
            if self.autostep:
                self.mgr.step()
            cfg = self.mgr.cfg
            w = self.world
            host = world_to_host(self.mgr.state, w)
            slots = np.flatnonzero(host.alive)
            sel_slot = self._selected_slot(host.alive)
            agents = [{"x": float(host.pos[slot, 0]),
                       "y": float(host.pos[slot, 1]),
                       "h": float(host.heading[slot]),
                       "species": int(host.species[slot]),
                       "health": int(host.health[slot])} for slot in slots]
            food = []
            for c, p in zip(*np.nonzero(host.food_count)):
                cx, cy = c % cfg.num_chunks_x, c // cfg.num_chunks_x
                food.append([float(cx * cfg.chunk_width + host.food_cell[c, p, 0]),
                             float(cy * cfg.chunk_width + host.food_cell[c, p, 1])])
            return {
                "world": w,
                "sel": int(np.searchsorted(slots, sel_slot)) if slots.size else 0,
                "step": host.step_count,
                "alive": int(host.alive.sum()),
                "lim": [cfg.world_lim_x, cfg.world_lim_y],
                "chunk": cfg.chunk_width,
                "agents": agents,
                "food": food,
                "depth": host.sensor_depth[sel_slot].tolist(),
                "semantic": host.sensor_semantic[sel_slot].tolist(),
            }


def make_server(viewer: WebViewer, port: int = 0) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                body = _PAGE.encode()
                ctype = "text/html"
            elif url.path in ("/state", "/step"):
                keys = parse_qs(url.query).get("keys", [""])[0].split(",")
                snap = viewer.step_and_snapshot(
                    keys if url.path == "/step" else ())
                body = json.dumps(snap).encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num_worlds", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init_agents", type=int, default=32)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default CUDA (raises without a card)")
    args = p.parse_args(argv)
    viewer = WebViewer(args.num_worlds, args.seed, args.init_agents,
                       device=resolve(args.device))
    srv = make_server(viewer, args.port)
    print(f"serving on http://127.0.0.1:{srv.server_address[1]}/  (ctrl-c to stop)")
    srv.serve_forever()


if __name__ == "__main__":
    main()
