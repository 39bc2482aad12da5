"""Web UI: cluster overview page.

Reference: the coordinator web UI (``core/trino-main/src/main/resources/webapp/``
React app + ``server/ui/ClusterStatsResource.java``). A single self-refreshing
page served at ``/ui`` over the existing JSON endpoints — no build step,
no external assets. Clicking a query row expands a per-stage timeline
rendered from ``/v1/query/{id}/timeline`` span data (stage + task_attempt
bars, offset from the query root span).

A copy of ``trino_tpu/server/webui.py``.
"""

PAGE = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>trino-tpu</title>
<style>
  body { font-family: ui-monospace, Menlo, monospace; margin: 2rem;
         background: #16161d; color: #e6e6ef; }
  h1 { font-size: 1.2rem; } h1 span { color: #7aa2f7; }
  .tiles { display: flex; gap: 1rem; flex-wrap: wrap; margin: 1rem 0; }
  .tile { background: #1f1f2b; padding: .8rem 1.2rem; border-radius: 8px; }
  .tile .v { font-size: 1.6rem; color: #9ece6a; }
  .tile .l { font-size: .75rem; color: #9aa0b0; }
  table { border-collapse: collapse; width: 100%; margin-top: 1rem; }
  th, td { text-align: left; padding: .35rem .6rem; font-size: .8rem;
           border-bottom: 1px solid #2a2a38; }
  th { color: #9aa0b0; font-weight: normal; }
  .FINISHED { color: #9ece6a; } .FAILED { color: #f7768e; }
  .RUNNING, .QUEUED, .PLANNING { color: #e0af68; }
  td.q { max-width: 40rem; overflow: hidden; text-overflow: ellipsis;
         white-space: nowrap; }
  tr.qrow { cursor: pointer; }
  tr.qrow:hover td { background: #1f1f2b; }
  .tl { padding: .6rem; }
  .tlrow { display: flex; align-items: center; gap: .6rem;
           margin: .15rem 0; }
  .tlname { width: 16rem; font-size: .72rem; color: #9aa0b0;
            overflow: hidden; text-overflow: ellipsis; white-space: nowrap; }
  .tltrack { flex: 1; position: relative; height: .9rem;
             background: #1f1f2b; border-radius: 3px; }
  .tlbar { position: absolute; height: 100%; border-radius: 3px;
           background: #7aa2f7; min-width: 2px; }
  .tlbar.stage { background: #bb9af7; }
  .tlbar.err { background: #f7768e; }
  .tlbar.spec { background: #e0af68; }
  .tlbar.spec.cancelled { background: #565f89; }
  .tlbar.rec { background: #73daca; }
  .tlms { width: 6rem; font-size: .72rem; color: #9aa0b0;
          text-align: right; }
  table.stages { width: auto; margin: .4rem 0 .6rem .6rem; }
  table.stages th, table.stages td { font-size: .72rem;
          padding: .2rem .5rem; border-bottom: 1px solid #2a2a38; }
  table.stages td.num { text-align: right; }
</style>
</head>
<body>
<h1><span>trino-tpu</span> cluster overview</h1>
<div class="tiles">
  <div class="tile"><div class="v" id="queries">-</div><div class="l">queries tracked</div></div>
  <div class="tile"><div class="v" id="running">-</div><div class="l">running</div></div>
  <div class="tile"><div class="v" id="mem">-</div><div class="l">HBM pool reserved</div></div>
  <div class="tile"><div class="v" id="state">-</div><div class="l">node state</div></div>
</div>
<table id="qtable">
  <tr><th>query id</th><th>state</th><th>user</th><th>elapsed</th><th>query</th></tr>
</table>
<script>
const open = new Set();  // query ids with an expanded timeline

function bar(span, t0, total, cls) {
  const left = total > 0 ? ((span.startMs - t0) / total) * 100 : 0;
  const width = total > 0 ? ((span.durationMs || 0) / total) * 100 : 0;
  const a = span.attrs || {};
  let c = cls;
  // speculative attempts render distinctly: amber for the hedge,
  // muted for whichever attempt lost the race and was cancelled.
  // Recovery (teal) covers every tier: spool re-points, lineage
  // re-execution, and whole fused-unit re-runs (attrs.fused) alike
  if (a.speculative) c += ' spec';
  if (a.recovered) c += ' rec';
  if (a.state === 'CANCELED_SPECULATIVE') c += ' spec cancelled';
  if (span.status === 'ERROR') c += ' err';
  return `<div class="tlbar ${c}" style="left:${Math.max(0, left).toFixed(2)}%;` +
         `width:${Math.max(0.2, width).toFixed(2)}%"></div>`;
}

function renderTimeline(tl) {
  const esc = s => String(s).replace(/&/g, '&amp;').replace(/</g, '&lt;');
  const spans = tl.spans || [];
  if (!spans.length) return '<div class="tl">no spans recorded</div>';
  const t0 = Math.min(...spans.map(s => s.startMs));
  const total = Math.max(...spans.map(
      s => (s.startMs - t0) + (s.durationMs || 0)));
  const interesting = spans.filter(
      s => ['query', 'stage', 'task_attempt', 'task_execute',
            'plan', 'optimize', 'fragment'].includes(s.name))
    .sort((a, b) => a.startMs - b.startMs);
  const label = s => {
    const a = s.attrs || {};
    if (s.name === 'stage') return `stage ${a.stage}` +
        (a.coordinator ? ' (coordinator)' : ` · ${a.tasks} tasks`);
    if (s.name === 'task_attempt') return `  ${a.taskId}` +
        (a.retry ? ' (retry)' : '') +
        (a.speculative ? ' (speculative)' : '') +
        (a.recovered ? ' (recovered)' : '') +
        (a.state === 'CANCELED_SPECULATIVE' ? ' (lost race)' : '');
    if (s.name === 'task_execute') return `  exec ${a.taskId}`;
    return s.name;
  };
  return '<div class="tl">' + interesting.map(s =>
    `<div class="tlrow"><div class="tlname">${esc(label(s))}</div>` +
    `<div class="tltrack">` +
    bar(s, t0, total, s.name === 'stage' || s.name === 'query' ? 'stage' : '') +
    `</div><div class="tlms">${(s.durationMs || 0).toFixed(1)} ms</div></div>`
  ).join('') + '</div>';
}

// per-stage device-profiler columns (queryStats.stages merged by the
// coordinator from worker task stats: rows / wall / exchange bytes /
// XLA cost-analysis FLOPs / peak HBM). Blank cells mean the backend
// reported no cost model (e.g. CPU) — the row layout stays stable.
function renderStages(q) {
  const stages = ((q.queryStats || {}).stages) || [];
  if (!stages.length) return '';
  const esc = s => String(s).replace(/&/g, '&amp;').replace(/</g, '&lt;');
  const num = v => (v === null || v === undefined) ? '' :
      Number(v).toLocaleString();
  const flops = v => (v === null || v === undefined) ? '' :
      Number(v).toExponential(2);
  // capacity provenance: which of default/seeded/history (+grown/+halved
  // corrections) the stage's capacity sites ran on — 'history' means the
  // query ran on observed truth, a '+' suffix means the estimate missed
  const prov = ex => {
    const caps = ex.capacities || {};
    const seen = new Set();
    for (const k of Object.keys(caps)) {
      const p = (caps[k] || {}).provenance;
      if (p) seen.add(p);
    }
    return Array.from(seen).sort().join(' ');
  };
  const rows = stages.map(s => {
    const ex = s.exchange || {};
    return `<tr><td>${esc(s.stage)}</td>` +
      `<td class="num">${num(s.tasks)}</td>` +
      `<td class="num">${num(s.rows)}</td>` +
      `<td class="num">${(s.elapsedMs || 0).toFixed(1)}</td>` +
      `<td class="num">${num(ex.shuffle_bytes)}</td>` +
      `<td class="num">${flops(s.flops)}</td>` +
      `<td class="num">${num(s.peakHbmBytes)}</td>` +
      `<td>${esc(prov(ex))}</td></tr>`;
  });
  return '<table class="stages"><tr><th>stage</th><th>tasks</th>' +
    '<th>rows</th><th>wall ms</th><th>shuffle B</th>' +
    '<th>flops</th><th>peak HBM B</th><th>capacity prov</th></tr>' +
    rows.join('') + '</table>';
}

// per-operator row flow (operatorStats: the in-program op! counter
// channel, cluster-merged). Sites are restart-stable `kind@stage#ord`
// names; rows group under their stage so the table reads top-down in
// the same order as the span waterfall above it.
function renderOperators(q) {
  const ops = q.operatorStats || {};
  const sites = Object.keys(ops);
  if (!sites.length) return '';
  const esc = s => String(s).replace(/&/g, '&amp;').replace(/</g, '&lt;');
  const num = v => (v === null || v === undefined) ? '' :
      Number(v).toLocaleString();
  const stageOf = site => {
    const m = site.match(/@(\\d+)/);
    return m ? Number(m[1]) : 1e9;
  };
  sites.sort((a, b) => stageOf(a) - stageOf(b) || a.localeCompare(b));
  let lastStage = null;
  const rows = [];
  for (const site of sites) {
    const ent = ops[site] || {};
    const stage = stageOf(site);
    const rin = Number(ent.rows_in || 0);
    const rout = Number(ent.rows_out || 0);
    const sel = rin > 0 ? (rout / rin).toFixed(3) : '';
    const stageCell = stage === lastStage ? '' : `stage ${stage}`;
    lastStage = stage;
    rows.push(`<tr><td>${esc(stageCell)}</td><td>${esc(site)}</td>` +
      `<td>${esc(ent.kind || '')}</td>` +
      `<td class="num">${num(rin)}</td>` +
      `<td class="num">${num(rout)}</td>` +
      `<td class="num">${sel}</td></tr>`);
  }
  return '<table class="stages"><tr><th>stage</th><th>operator site</th>' +
    '<th>kind</th><th>rows in</th><th>rows out</th><th>selectivity</th>' +
    '</tr>' + rows.join('') + '</table>';
}

async function toggleTimeline(qid) {
  if (open.has(qid)) open.delete(qid); else open.add(qid);
  refresh();
}

async function refresh() {
  const st = await (await fetch('/v1/status')).json();
  const qs = await (await fetch('/v1/query')).json();
  document.getElementById('queries').textContent = qs.length;
  document.getElementById('running').textContent =
      qs.filter(q => !['FINISHED','FAILED','CANCELED'].includes(q.state)).length;
  const mb = st.memoryInfo.reservedBytes / (1024 * 1024);
  document.getElementById('mem').textContent = mb.toFixed(1) + ' MB';
  document.getElementById('state').textContent = st.state;
  const esc = s => String(s).replace(/&/g, '&amp;').replace(/</g, '&lt;')
      .replace(/>/g, '&gt;').replace(/"/g, '&quot;');
  const stateClass = s => ['FINISHED','FAILED','RUNNING','QUEUED','PLANNING']
      .includes(s) ? s : '';
  const sorted = qs.sort((a, b) => b.createTime - a.createTime).slice(0, 50);
  const rows = [];
  for (const q of sorted) {
    rows.push(
      `<tr class="qrow" onclick="toggleTimeline('${esc(q.queryId)}')">` +
      `<td>${esc(q.queryId)}</td><td class="${stateClass(q.state)}">${esc(q.state)}</td>` +
      `<td>${esc(q.user)}</td><td>${esc(q.elapsedTimeMillis)} ms</td>` +
      `<td class="q">${esc(q.query)}</td></tr>`);
    if (open.has(q.queryId)) {
      let tl = {spans: []};
      try {
        tl = await (await fetch(
            '/v1/query/' + encodeURIComponent(q.queryId) + '/timeline')).json();
      } catch (e) { /* timeline unavailable */ }
      rows.push(`<tr><td colspan="5">${renderStages(q)}` +
        `${renderOperators(q)}${renderTimeline(tl)}</td></tr>`);
    }
  }
  document.getElementById('qtable').innerHTML =
    '<tr><th>query id</th><th>state</th><th>user</th><th>elapsed</th><th>query</th></tr>' +
    rows.join('');
}
refresh(); setInterval(refresh, 2000);
</script>
</body>
</html>
"""
