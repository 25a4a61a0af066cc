"""The WebSocket bridge between the browser page of ``examples/browser/``
and the port's ``StreamServer`` (``python -m
melspec_tpu_torch.examples.browser.server``)."""
