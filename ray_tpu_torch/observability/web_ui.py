"""Dashboard web UI — a dependency-free single page over the REST API.

Reference: dashboard/client/ (a React SPA consuming the dashboard REST
endpoints). This build serves the same information — cluster summary,
per-node resources/object-store/worker stats, the actor table, jobs and
live worker logs — as one self-contained HTML page with vanilla-JS
polling (no build step, no npm tree), which is the appropriate weight
for a head process whose API is already JSON. The REST surface stays
the contract; the page is a thin consumer like the reference SPA."""

INDEX_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>ray_tpu_torch dashboard</title>
<style>
  :root { color-scheme: light dark; }
  body { font-family: ui-monospace, SFMono-Regular, Menlo, monospace;
         margin: 1.5rem; line-height: 1.45; }
  h1 { font-size: 1.2rem; } h2 { font-size: 1rem; margin-top: 1.6rem; }
  table { border-collapse: collapse; width: 100%; font-size: 0.85rem; }
  th, td { border: 1px solid #8884; padding: 0.25rem 0.5rem;
           text-align: left; vertical-align: top; }
  th { background: #8882; }
  .ok { color: #2e7d32; } .bad { color: #c62828; }
  #logs { white-space: pre-wrap; font-size: 0.8rem; max-height: 20rem;
          overflow-y: auto; border: 1px solid #8884; padding: 0.5rem; }
  .muted { opacity: 0.65; font-size: 0.8rem; }
</style>
</head>
<body>
<h1>ray_tpu_torch dashboard</h1>
<div class="muted">auto-refreshes every 2s; data from /api/cluster,
/api/nodes, /api/actors, /api/jobs, /api/logs</div>
<h2>Cluster</h2><div id="cluster">loading…</div>
<h2>Nodes</h2><table id="nodes"></table>
<h2>Actors</h2><table id="actors"></table>
<h2>Jobs</h2><table id="jobs"></table>
<h2>Recent logs</h2><div id="logs"></div>
<script>
const esc = (s) => s.replace(/[&<>"']/g, (c) => ({"&": "&amp;",
  "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;"}[c]));
// every value is escaped before innerHTML interpolation: actor names,
// job entrypoints and resource names are user-controlled strings and
// must never execute in the operator's browser
const fmt = (x) => x === null || x === undefined ? "" :
  esc(typeof x === "object" ? JSON.stringify(x) : String(x));
function table(el, rows, cols) {
  if (!rows.length) { el.innerHTML = "<tr><td class=muted>none</td></tr>"; return; }
  let html = "<tr>" + cols.map(c => `<th>${esc(c)}</th>`).join("") + "</tr>";
  for (const r of rows)
    html += "<tr>" + cols.map(c => `<td>${fmt(r[c])}</td>`).join("") + "</tr>";
  el.innerHTML = html;
}
async function j(path) { const r = await fetch(path); return r.json(); }
async function refresh() {
  try {
    const [cluster, nodes, actors, jobs, logs] = await Promise.all([
      j("/api/cluster"), j("/api/nodes"), j("/api/actors"),
      j("/api/jobs"), j("/api/logs?n=200")]);
    const ns = Object.values(cluster.nodes || {});
    const alive = ns.filter(n => n.alive).length;
    document.getElementById("cluster").innerHTML =
      `<span class="${alive === ns.length ? "ok" : "bad"}">` +
      `${alive}/${ns.length} nodes alive</span>`;
    table(document.getElementById("nodes"),
      nodes.map(n => ({node: (n.node_id || "").slice(0, 8),
        resources: n.resources, available: n.available,
        queued: n.queued, running: n.running, store: n.store,
        workers: n.pool, agent: n.agent})),
      ["node", "resources", "available", "queued", "running",
       "store", "workers", "agent"]);
    table(document.getElementById("actors"),
      (actors || []).map(a => ({actor: (a.actor_id || "").slice(0, 8),
        name: a.name, state: a.state,
        node: (a.node_id || "").slice(0, 8),
        restarts: `${a.restarts_used}/${a.max_restarts}`})),
      ["actor", "name", "state", "node", "restarts"]);
    table(document.getElementById("jobs"),
      (jobs || []).map(jb => ({job: (jb.job_id || "").slice(0, 12),
        status: jb.status, entrypoint: jb.entrypoint})),
      ["job", "status", "entrypoint"]);
    document.getElementById("logs").textContent =
      (logs || []).map(l => `[${(l.node_id || "").slice(0, 8)}:` +
                            `${l.pid}] ${l.line}`).join("\\n");
  } catch (e) {
    document.getElementById("cluster").innerHTML =
      `<span class=bad>head unreachable: ${e}</span>`;
  }
}
refresh();
setInterval(refresh, 2000);
</script>
</body>
</html>
"""
