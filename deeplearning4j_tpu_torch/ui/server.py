"""UIServer: training dashboard over a StatsStorage; the port of
`deeplearning4j_tpu/ui/server.py`, serving the same page and JSON.

Parity with `ui/play/PlayUIServer.java:53` + `ui/api/UIServer.java:14`
(singleton `get_instance()`, `attach(storage)`) and the TrainModule pages
(overview / model / system, `module/train/TrainModule.java:53`). The
reference embeds a Play server with Scala views + TS charts; here it's a
dependency-free stdlib ThreadingHTTPServer serving one HTML page that polls
JSON endpoints and renders inline-SVG charts (works offline, no CDN).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..util.host import host_array
from .storage import StatsStorage

__all__ = ["UIServer"]

_PAGE = """<!DOCTYPE html>
<html><head><title>deeplearning4j_tpu training UI</title><style>
body{font-family:sans-serif;margin:20px;background:#fafafa}
h1{font-size:18px} h2{font-size:15px;margin:18px 0 6px}
.tab{display:inline-block;margin-right:12px;cursor:pointer;color:#06c}
.tab.active{font-weight:bold;color:#000}
table{border-collapse:collapse;font-size:12px}
td,th{border:1px solid #ccc;padding:3px 8px;text-align:right}
th{background:#eee} svg{background:#fff;border:1px solid #ddd}
#meta{color:#666;font-size:12px}
</style></head><body>
<h1>deeplearning4j_tpu &mdash; training</h1>
<div id="meta"></div>
<div><span class="tab active" data-p="overview">Overview</span>
<span class="tab" data-p="model">Model</span>
<span class="tab" data-p="flow">Flow</span>
<span class="tab" data-p="histograms">Histograms</span>
<span class="tab" data-p="tsne">t-SNE</span>
<span class="tab" data-p="system">System</span></div>
<div id="content"></div>
<script>
let page='overview';
document.querySelectorAll('.tab').forEach(t=>t.onclick=()=>{
  document.querySelectorAll('.tab').forEach(x=>x.classList.remove('active'));
  t.classList.add('active'); page=t.dataset.p; refresh();});
function bars(hist,w,h,color){
  if(!hist||!hist.counts||!hist.counts.length)
    return '<svg width="'+w+'" height="'+h+'"></svg>';
  const n=hist.counts.length, mx=Math.max(...hist.counts)||1;
  let s='<svg width="'+w+'" height="'+h+'">';
  const bw=(w-40)/n;
  hist.counts.forEach((c,i)=>{
    const bh=c/mx*(h-24);
    s+='<rect x="'+(20+i*bw)+'" y="'+(h-12-bh)+'" width="'+Math.max(1,bw-1)+
      '" height="'+bh+'" fill="'+color+'" fill-opacity="0.85"/>';});
  s+='<text x="4" y="'+(h-2)+'" font-size="9">'+hist.min.toPrecision(3)+
    '</text><text x="'+(w-4)+'" y="'+(h-2)+'" text-anchor="end" font-size="9">'+
    hist.max.toPrecision(3)+'</text></svg>';
  return s;
}
function line(xs,ys,w,h,color){
  if(ys.length<2) return '<svg width="'+w+'" height="'+h+'"></svg>';
  const mn=Math.min(...ys), mx=Math.max(...ys), sp=(mx-mn)||1;
  const pts=ys.map((y,i)=>((i/(ys.length-1))*(w-20)+10)+','+
    (h-10-((y-mn)/sp)*(h-20))).join(' ');
  return '<svg width="'+w+'" height="'+h+'"><polyline fill="none" stroke="'+
    color+'" stroke-width="1.5" points="'+pts+'"/>'+
    '<text x="4" y="12" font-size="10">'+mx.toPrecision(4)+'</text>'+
    '<text x="4" y="'+(h-2)+'" font-size="10">'+mn.toPrecision(4)+'</text></svg>';
}
function flow(model,params){
  // FlowListenerModule analog: vertices laid out by topological depth,
  // edges as lines, per-vertex param counts + latest param stdev
  if(!model||!model.length) return '<p>no model info in this session</p>';
  const depth={}, rows={}, pos={};
  model.forEach(v=>{
    depth[v.name]=v.inputs.length?
      1+Math.max(...v.inputs.map(i=>depth[i]??0)):0;});
  model.forEach(v=>{
    const d=depth[v.name]; rows[d]=(rows[d]??0);
    pos[v.name]=[d,rows[d]]; rows[d]++;});
  const BW=140,BH=40,GX=40,GY=14;
  const W=(Math.max(...Object.values(depth))+1)*(BW+GX)+20;
  const H=(Math.max(...Object.values(rows))+0)*(BH+GY)+20;
  let s='<svg width="'+W+'" height="'+H+'">';
  const xy=n=>{const p=pos[n];
    return [10+p[0]*(BW+GX), 10+p[1]*(BH+GY)];};
  model.forEach(v=>v.inputs.forEach(i=>{
    if(!(i in pos)) return;
    const a=xy(i), b=xy(v.name);
    s+='<line x1="'+(a[0]+BW)+'" y1="'+(a[1]+BH/2)+'" x2="'+b[0]+
      '" y2="'+(b[1]+BH/2)+'" stroke="#999"/>';}));
  model.forEach(v=>{
    const p=xy(v.name);
    const st=Object.entries(params).find(([k,_])=>k.startsWith(v.name+'/'));
    s+='<rect x="'+p[0]+'" y="'+p[1]+'" width="'+BW+'" height="'+BH+
      '" rx="4" fill="'+(v.type=='Input'?'#dde':'#fff')+
      '" stroke="#36c"/>'+
      '<text x="'+(p[0]+5)+'" y="'+(p[1]+14)+'" font-size="11" '+
      'font-weight="bold">'+v.name+'</text>'+
      '<text x="'+(p[0]+5)+'" y="'+(p[1]+27)+'" font-size="9">'+v.type+
      ' · '+v.n_params+'p'+(st?' · σ '+st[1].stdev.toPrecision(2):'')+
      '</text>';});
  return s+'</svg>';
}
async function refresh(){
  const d=await (await fetch('/train/data.json')).json();
  document.getElementById('meta').textContent=
    'session '+d.session+' · '+d.iterations.length+' reports · last score '+
    (d.scores.at(-1)??'-');
  let html='';
  if(page=='overview'){
    html+='<h2>Score vs iteration</h2>'+line(d.iterations,d.scores,640,220,'#c33');
    if(d.samples_per_sec.length)
      html+='<h2>samples/sec</h2>'+line(d.iterations,d.samples_per_sec,640,140,'#36c');
  } else if(page=='model'){
    html+='<h2>Parameters (latest)</h2><table><tr><th>param</th><th>mean</th>'+
      '<th>stdev</th><th>min</th><th>max</th><th>update stdev</th></tr>';
    for(const [k,v] of Object.entries(d.params))
      html+='<tr><td style="text-align:left">'+k+'</td><td>'+v.mean.toPrecision(4)+
        '</td><td>'+v.stdev.toPrecision(4)+'</td><td>'+v.min.toPrecision(4)+
        '</td><td>'+v.max.toPrecision(4)+'</td><td>'+
        (d.updates[k]?d.updates[k].stdev.toPrecision(4):'-')+'</td></tr>';
    html+='</table>';
    html+='<h2>Mean parameter stdev vs iteration</h2>'+
      line(d.iterations,d.param_stdev,640,140,'#393');
  } else if(page=='flow'){
    html+='<h2>Network structure</h2>'+flow(d.model,d.params);
  } else if(page=='tsne'){
    const t=await (await fetch('/tsne/data.json')).json();
    if(!t.points||!t.points.length){
      html+='<p>no t-SNE coordinates attached '+
        '(UIServer.attach_tsne(coords, labels))</p>';
    } else {
      const xs=t.points.map(p=>p[0]), ys=t.points.map(p=>p[1]);
      const mnx=Math.min(...xs), mxx=Math.max(...xs),
            mny=Math.min(...ys), mxy=Math.max(...ys);
      const W=640,H=480,pal=['#c33','#36c','#393','#939','#c93','#399',
                             '#663','#636','#366','#933'];
      const cls=[...new Set(t.labels??[])];
      let s='<svg width="'+W+'" height="'+H+'">';
      t.points.forEach((p,i)=>{
        const x=10+(p[0]-mnx)/((mxx-mnx)||1)*(W-20);
        const y=10+(p[1]-mny)/((mxy-mny)||1)*(H-20);
        const c=t.labels?pal[cls.indexOf(t.labels[i])%pal.length]:'#36c';
        s+='<circle cx="'+x+'" cy="'+y+'" r="3" fill="'+c+
          '" fill-opacity="0.7"><title>'+(t.labels?t.labels[i]:i)+
          '</title></circle>';});
      html+='<h2>t-SNE embedding ('+t.points.length+' points)</h2>'+
        s+'</svg>';
      if(cls.length)
        html+='<p>'+cls.map((c,i)=>'<span style="color:'+
          pal[i%pal.length]+'">&#9679; '+c+'</span>').join(' &nbsp; ')+
          '</p>';
    }
  } else if(page=='histograms'){
    for(const [k,v] of Object.entries(d.params)){
      html+='<h2>'+k+'</h2>'+bars(v.histogram,320,110,'#36c');
      if(d.updates[k])
        html+=' '+bars(d.updates[k].histogram,320,110,'#c63');
    }
    if(!Object.keys(d.params).length)
      html+='<p>no parameter histograms collected '+
        '(StatsListener(collect_histograms=True))</p>';
  } else {
    html+='<h2>Host RSS (MB)</h2>'+line(d.iterations,d.rss_mb,640,140,'#939');
  }
  document.getElementById('content').innerHTML=html;
}
refresh(); setInterval(refresh, 2000);
</script></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    server_version = "dl4jtpu-ui"

    def log_message(self, *a):  # quiet
        pass

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        ui: "UIServer" = self.server.ui  # type: ignore[attr-defined]
        url = urlparse(self.path)
        if url.path in ("/", "/train", "/train/overview"):
            body = _PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if url.path == "/train/sessions.json":
            self._json(ui.sessions())
            return
        if url.path == "/train/data.json":
            q = parse_qs(url.query)
            session = q.get("session", [None])[0]
            self._json(ui.train_data(session))
            return
        if url.path == "/tsne/data.json":
            self._json(ui.tsne_data())
            return
        self._json({"error": "not found"}, 404)

    def do_POST(self):
        """Remote stats ingestion (`RemoteReceiverModule` analog): workers
        POST updates from `RemoteUIStatsStorageRouter`."""
        ui: "UIServer" = self.server.ui  # type: ignore[attr-defined]
        if urlparse(self.path).path != "/remote":
            self._json({"error": "not found"}, 404)
            return
        if ui.remote_storage is None:
            self._json({"error": "remote listener not enabled"}, 403)
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(n) or b"{}")
            ui.remote_storage.put_update(
                body["session"], body.get("type", "remote"),
                body.get("worker", "0"), float(body.get("ts", 0.0)),
                body.get("report", {}))
            self._json({"status": "ok"})
        except Exception as e:
            self._json({"error": f"{type(e).__name__}: {e}"}, 400)


class UIServer:
    """Singleton dashboard server (`UIServer.getInstance()` in the
    reference). attach() storages; start() binds the port."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000, host: str = "127.0.0.1"):
        self.port = port
        self.host = host  # bind 0.0.0.0 to receive remote worker stats
        self._storages: List[StatsStorage] = []
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.remote_storage: Optional[StatsStorage] = None

    def attach_tsne(self, coords, labels=None) -> "UIServer":
        """Attach 2-D embedding coordinates for the t-SNE tab (reference
        `module/tsne/TsneModule.java`: uploaded coordinate files rendered
        as a scatter). `coords`: [N, 2] array-like or a tensor on any device
        (copied to the host once); `labels`: optional N strings for
        coloring/tooltips."""
        c = host_array(coords, np.float64)
        if c.ndim != 2 or c.shape[1] < 2:
            raise ValueError("coords must be [N, >=2]")
        self._tsne = {"points": c[:, :2].tolist(),
                      "labels": (None if labels is None
                                 else [str(l) for l in labels])}
        return self

    def tsne_data(self) -> dict:
        return getattr(self, "_tsne", {"points": [], "labels": None})

    def enable_remote_listener(self, storage: Optional[StatsStorage] = None
                               ) -> "UIServer":
        """Accept POSTed stats from remote workers at /remote (reference
        RemoteReceiverModule) into `storage` (default: a fresh in-memory
        storage), which is also attached to the dashboard."""
        from .storage import InMemoryStatsStorage

        self.remote_storage = storage or InMemoryStatsStorage()
        return self.attach(self.remote_storage)

    @classmethod
    def get_instance(cls, port: int = 9000,
                     host: str = "127.0.0.1") -> "UIServer":
        if cls._instance is None:
            cls._instance = UIServer(port, host=host)
        return cls._instance

    def attach(self, storage: StatsStorage) -> "UIServer":
        if storage not in self._storages:
            self._storages.append(storage)
        return self

    def detach(self, storage: StatsStorage) -> "UIServer":
        if storage in self._storages:
            self._storages.remove(storage)
        return self

    # -- data assembly (TrainModule's JSON endpoints) --------------------
    def sessions(self) -> List[str]:
        out = []
        for st in self._storages:
            out.extend(st.list_session_ids())
        return out

    def _updates(self, session: Optional[str]):
        """The first (type, worker) stream of `session` in whichever
        attached storage holds it; else, as in JAX, of the first storage's
        latest session. (JAX's looks only in the first storage that has any
        session, so a session held by a later one is never served.)"""
        holders = [st for st in self._storages
                   if session in st.list_session_ids()]
        for st in holders or self._storages:
            sessions = st.list_session_ids()
            if not sessions:
                continue
            sid = session if session in sessions else sessions[-1]
            for typ in st.list_type_ids(sid):
                for worker in st.list_worker_ids(sid, typ):
                    return sid, st.get_all_updates(sid, typ, worker)
        return None, []

    def train_data(self, session: Optional[str] = None) -> dict:
        sid, updates = self._updates(session)
        reports = [r for _, r in updates]
        latest = reports[-1] if reports else {}
        param_stdev = []
        for r in reports:
            ps = r.get("params") or {}
            param_stdev.append(
                float(np.mean([v["stdev"] for v in ps.values()]))
                if ps else 0.0)
        model = next((r["model"] for r in reports if "model" in r), [])
        return {
            "session": sid,
            "iterations": [r.get("iteration", i)
                           for i, r in enumerate(reports)],
            "scores": [r.get("score") for r in reports],
            "samples_per_sec": [r["perf"]["samples_per_sec"]
                                for r in reports if "perf" in r],
            "rss_mb": [r.get("memory", {}).get("rss_mb", 0) for r in reports],
            "param_stdev": param_stdev,
            "params": latest.get("params", {}),
            "updates": latest.get("updates", {}),
            "model": model,
        }

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "UIServer":
        if self._httpd is not None:
            return self
        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        self.port = self._httpd.server_address[1]
        self._httpd.ui = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="dl4jtpu-ui")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None
