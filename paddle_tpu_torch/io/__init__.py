"""paddle_tpu_torch.io — the port of ``paddle_tpu/io``: so far the
generation server and its client over the frame protocol
(``io.serving``). Checkpoints, datasets and export (``io/export.py``'s
``Predictor``, ROADMAP A7) are not ported."""

from paddle_tpu_torch.io.serving import (InferenceClient, InferenceServer,
                                         ModelBusyError)

__all__ = ["InferenceServer", "InferenceClient", "ModelBusyError"]
