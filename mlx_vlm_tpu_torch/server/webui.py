"""Built-in single-page web chat UI.

Port of mlx_vlm_tpu/server/webui.py, verbatim: a dependency-free HTML/JS
page at `/` that streams from /v1/chat/completions (SSE) and supports
image attachments (sent as base64 data URIs).
"""

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>mlx_vlm_tpu chat</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:780px;margin:2rem auto;
      background:#111;color:#eee;padding:0 1rem}
 #log{white-space:pre-wrap;border:1px solid #333;border-radius:8px;
      padding:1rem;min-height:300px;margin-bottom:1rem}
 .u{color:#8fd}.a{color:#fd8}
 textarea{width:100%;background:#222;color:#eee;border:1px solid #444;
      border-radius:6px;padding:.5rem;font-size:1rem}
 button{background:#2a6;border:0;color:#fff;padding:.5rem 1.2rem;
      border-radius:6px;font-size:1rem;cursor:pointer;margin-top:.5rem}
 img.thumb{max-height:60px;border-radius:4px;margin:.2rem}
</style></head><body>
<h2>mlx_vlm_tpu</h2>
<div id="log"></div>
<textarea id="msg" rows="3" placeholder="Message... (Ctrl-Enter to send)"></textarea>
<div><input type="file" id="img" accept="image/*" multiple>
<button onclick="send()">Send</button></div>
<script>
const history = [];
let images = [];
document.getElementById('img').onchange = async (e) => {
  images = [];
  for (const f of e.target.files) {
    images.push(await new Promise(r => {
      const fr = new FileReader();
      fr.onload = () => r(fr.result);
      fr.readAsDataURL(f);
    }));
  }
};
document.getElementById('msg').addEventListener('keydown', e => {
  if (e.key === 'Enter' && e.ctrlKey) send();
});
async function send() {
  const ta = document.getElementById('msg');
  const text = ta.value.trim();
  if (!text) return;
  ta.value = '';
  const log = document.getElementById('log');
  log.innerHTML += `<span class="u">you&gt;</span> ${text}\\n`;
  const content = images.length
    ? [...images.map(u => ({type: 'image_url', image_url: {url: u}})),
       {type: 'text', text}]
    : text;
  history.push({role: 'user', content});
  images = [];
  document.getElementById('img').value = '';
  log.innerHTML += `<span class="a">model&gt;</span> `;
  const resp = await fetch('/v1/chat/completions', {
    method: 'POST', headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({messages: history, stream: true, max_tokens: 1024}),
  });
  const reader = resp.body.getReader();
  const dec = new TextDecoder();
  let buf = '', answer = '';
  while (true) {
    const {done, value} = await reader.read();
    if (done) break;
    buf += dec.decode(value, {stream: true});
    for (const line of buf.split('\\n\\n')) {
      if (!line.startsWith('data: ') || line.includes('[DONE]')) continue;
      try {
        const d = JSON.parse(line.slice(6));
        const t = d.choices?.[0]?.delta?.content;
        if (t) { answer += t; }
      } catch {}
    }
    buf = buf.slice(buf.lastIndexOf('\\n\\n') + 2);
    log.innerHTML = log.innerHTML.replace(/(<span class="a">model&gt;<\\/span> )[^]*?$/,
      `$1${answer.replace(/</g, '&lt;')}`);
    log.scrollTop = log.scrollHeight;
  }
  log.innerHTML += '\\n';
  history.push({role: 'assistant', content: answer});
}
</script></body></html>
"""
