"""Host entropy coding (TorchPipeline._serialize_slice: the native C++
CABAC, the slice header, the NAL) per frame emitted in the window."""

from hevcbench.spans import layer_seconds

SPANS = {"serialize": ("homerhevc_tpu_torch.engine.pipeline",
                       "TorchPipeline", ("_serialize_slice",))}


def read(t):
    if not t.window:
        return None
    return layer_seconds(t.spans, "serialize") / len(t.window) * 1e3
