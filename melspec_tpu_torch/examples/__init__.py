"""The port's example programs, each run as ``python -m
melspec_tpu_torch.examples.<name>``: the batched TCP serving server
(``serve_streams``), the WebSocket bridge for the browser page
(``browser.server``) and the CLIs ``live_pipeline``, ``mel_tga``,
``tga_to_asr``, ``stream_asr_segments``, ``waterfall`` and
``vad_ten_eval``. Each takes ``--device cuda|cpu``; without it the
program runs on CUDA and exits non-zero on a host without one."""
