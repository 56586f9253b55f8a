"""Interactive chat demo with audio upload, as ``audio_flamingo_tpu/serve/demo.py``: a
stdlib ThreadingHTTPServer serving a single-page app with microphone capture, WAV/FLAC
upload, multi-turn chat and a think-mode toggle, over the port's ``AudioFlamingo``.

Routes:
  GET  /            the single-page UI (inline HTML+JS; mic capture via Web Audio
                    ScriptProcessor downsampled to 16 kHz mono f32)
  POST /api/chat    {"prompt": str, "think": bool, "pcm_b64"?: base64 f32le PCM,
                     "file_b64"?: base64 WAV/FLAC bytes} -> {"text": str}
  POST /api/reset   clear the chat history

Uploaded sound is decoded on the handler's thread by the port's native ``audio/io``; a
file it cannot decode answers 400. Everything that touches the model (``generate``,
its CUDA work and its first call's CUDA-graph capture of the decode step, and the chat
history) runs under one lock, so no other thread issues CUDA work during a capture. An
exception from ``generate`` answers 500 and is raised on (the server logs it).

Launch: ``python -m audio_flamingo_tpu_torch.serve.demo --random-tiny`` (random weights,
no checkpoint) or ``--model <path>`` through ``api.load``; on CUDA unless ``--device`` says
otherwise.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>Audio Flamingo demo</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:760px;margin:2rem auto;padding:0 1rem}
 #log{border:1px solid #ccc;border-radius:8px;padding:1rem;min-height:200px;
      display:flex;flex-direction:column;gap:.5rem}
 .u{align-self:flex-end;background:#e3f2fd;border-radius:8px;padding:.4rem .7rem}
 .a{align-self:flex-start;background:#f1f8e9;border-radius:8px;padding:.4rem .7rem}
 .sys{color:#888;font-size:.85em}
 #row{display:flex;gap:.5rem;margin-top:1rem}
 #prompt{flex:1;padding:.5rem}
 button{padding:.5rem .9rem;cursor:pointer}
 #rec.on{background:#ef9a9a}
</style></head><body>
<h2>Audio Flamingo — demo</h2>
<div id="log"><div class="sys">Attach audio (mic or .wav/.flac) and ask about it.</div></div>
<div id="row">
 <input id="prompt" placeholder="Describe the audio." value="Describe the audio.">
 <label><input type="checkbox" id="think"> think</label>
 <button id="rec">&#127908; rec</button>
 <input type="file" id="file" accept=".wav,.flac" style="width:180px">
 <button id="send">send</button>
 <button id="reset">reset</button>
</div>
<script>
let pcm=null, fileB64=null, recording=false, ctx=null, proc=null, chunks=[];
const log=(cls,txt)=>{const d=document.createElement('div');d.className=cls;
  d.textContent=txt;document.getElementById('log').appendChild(d);}
document.getElementById('rec').onclick=async e=>{
  if(!recording){
    const stream=await navigator.mediaDevices.getUserMedia({audio:true});
    ctx=new AudioContext(); const src=ctx.createMediaStreamSource(stream);
    proc=ctx.createScriptProcessor(4096,1,1); chunks=[];
    proc.onaudioprocess=ev=>chunks.push(new Float32Array(ev.inputBuffer.getChannelData(0)));
    src.connect(proc); proc.connect(ctx.destination);
    recording=true; e.target.classList.add('on');
  }else{
    proc.disconnect(); const sr=ctx.sampleRate; ctx.close();
    recording=false; e.target.classList.remove('on');
    let n=chunks.reduce((a,c)=>a+c.length,0), all=new Float32Array(n), o=0;
    for(const c of chunks){all.set(c,o);o+=c.length;}
    const ratio=sr/16000, m=Math.floor(n/ratio), ds=new Float32Array(m);
    for(let i=0;i<m;i++) ds[i]=all[Math.floor(i*ratio)];
    pcm=btoa(String.fromCharCode(...new Uint8Array(ds.buffer)));
    log('sys',`mic clip: ${(m/16000).toFixed(1)} s`);
  }};
document.getElementById('file').onchange=async e=>{
  const f=e.target.files[0]; if(!f) return;
  const buf=await f.arrayBuffer();
  fileB64=btoa(new Uint8Array(buf).reduce((s,b)=>s+String.fromCharCode(b),''));
  log('sys',`file: ${f.name} (${buf.byteLength} bytes)`);};
document.getElementById('send').onclick=async()=>{
  const prompt=document.getElementById('prompt').value;
  log('u',prompt);
  const body={prompt,think:document.getElementById('think').checked};
  if(pcm) body.pcm_b64=pcm; else if(fileB64) body.file_b64=fileB64;
  pcm=null; fileB64=null; document.getElementById('file').value='';
  const r=await fetch('/api/chat',{method:'POST',body:JSON.stringify(body)});
  const j=await r.json();
  log(j.error?'sys':'a', j.error||j.text);};
document.getElementById('reset').onclick=async()=>{
  await fetch('/api/reset',{method:'POST'});
  document.getElementById('log').innerHTML='<div class="sys">history cleared</div>';};
</script></body></html>"""


class DemoServer:
    """Serve the chat demo over a model exposing ``.generate(sound, prompt, chat=,
    think=, max_new_tokens=)`` and ``.reset_chat()`` (the ``api.AudioFlamingo`` contract)."""

    def __init__(self, model, host: str = "127.0.0.1", port: int = 7860,
                 max_new_tokens: int = 256, target_sr: int = 16_000):
        self.model = model
        self.max_new_tokens = max_new_tokens
        self.target_sr = target_sr
        self._lock = threading.Lock()   # model.generate + history is not reentrant
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # silence request logging
                pass

            def _json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path not in ("/", "/index.html"):
                    self._json(404, {"error": "not found"})
                    return
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self._json(400, {"error": "bad json"})
                    return
                if self.path == "/api/reset":
                    with server._lock:
                        server.model.reset_chat()
                    self._json(200, {"ok": True})
                    return
                if self.path != "/api/chat":
                    self._json(404, {"error": "not found"})
                    return
                try:
                    sound = server._decode_sound(req)
                except Exception as e:  # noqa: BLE001 — surfaced to the UI
                    self._json(400, {"error": f"audio decode failed: {e}"})
                    return
                try:
                    with server._lock:
                        text = server.model.generate(
                            sound, req.get("prompt", "Describe the audio."),
                            chat=True, think=bool(req.get("think", False)),
                            max_new_tokens=server.max_new_tokens)
                except Exception as e:
                    self._json(500, {"error": f"generate failed: {type(e).__name__}: {e}"})
                    raise
                self._json(200, {"text": text})

        self.httpd = ThreadingHTTPServer((host, port), Handler)

    def _decode_sound(self, req: dict) -> np.ndarray | None:
        from audio_flamingo_tpu_torch.audio.io import decode_audio, resample

        if req.get("pcm_b64"):
            return np.frombuffer(base64.b64decode(req["pcm_b64"]), np.float32).copy()
        if req.get("file_b64"):
            wav, sr = decode_audio(base64.b64decode(req["file_b64"]))
            return resample(wav, sr, self.target_sr) if sr != self.target_sr else wav
        return None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self):
        print(f"demo: http://{self.httpd.server_address[0]}:{self.port}/", flush=True)
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Audio Flamingo chat demo")
    ap.add_argument("--model", help="checkpoint path for api.load")
    ap.add_argument("--random-tiny", action="store_true",
                    help="random tiny AF3 (no checkpoint; smoke/demo mode)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--quantize-lm", action="store_true")   # back-compat alias
    ap.add_argument("--quantize", choices=("none", "int8", "int4"), default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; raises without a card)")
    args = ap.parse_args(argv)

    from audio_flamingo_tpu_torch import api

    if args.random_tiny or not args.model:
        model = api.AudioFlamingo.from_random(device=args.device)
    else:
        quant = args.quantize or ("int8" if args.quantize_lm else "none")
        model = api.load(args.model,
                         quantize_lm={"none": False, "int8": "int8", "int4": "int4"}[quant],
                         device=args.device)
    DemoServer(model, host=args.host, port=args.port).serve_forever()


if __name__ == "__main__":
    main()
