"""Minimal ncnn model parser + PyTorch executor.

Counterpart of ``mpmvs_tpu.models.ncnn``. The reference runs its
sky-segmentation net with the ncnn inference engine
(SkySegment/src/SkyRegionDetect.cpp:620-640); here the public .param/.bin
formats (or the vendored .npz) are parsed with numpy, as in the JAX package,
and the graph runs as :class:`NcnnNet`, an ``nn.Module`` holding the weights
as buffers.

Supported layer types (the full set used by the sky model): Input,
Convolution (incl. dilation + ReLU/Sigmoid fusion), Split, Concat (axis 0 =
channels), Pooling (max), Interp (bilinear with explicit output size),
BinaryOp (add, mul), Sigmoid.

Numerics: convolutions are ``F.conv2d`` (the JAX package runs them as XLA
``conv_general_dilated``, outside any Pallas kernel), with cuDNN's TF32 off
inside the module so that a run on the card computes in float32 as the
tests do. Interp is ``jax.image.resize(..., "linear")`` there: half-pixel
centres, antialiased when it shrinks; ``F.interpolate(mode="bilinear",
align_corners=False, antialias=<shrinks>)`` computes the same.

ncnn format notes:
  * .param: magic 7767517; "layer_count blob_count"; then one line per
    layer: type, name, #in, #out, input blobs, output blobs, k=v params.
    Negative keys are arrays ("-233xx=count,v0,v1,...").
  * .bin: weights in layer order. A conv's weight blob is preceded by a
    4-byte tag (0 -> fp32, 0x01306B47 -> fp16 padded to 4-byte alignment,
    0x0002C056 -> raw fp32); the bias blob is always raw fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

TAG_FP32 = 0
TAG_FP16 = 0x01306B47
TAG_RAW = 0x0002C056


@dataclasses.dataclass
class NcnnLayer:
    type: str
    name: str
    inputs: List[str]
    outputs: List[str]
    params: Dict[int, object]
    weights: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def p(self, key: int, default=0):
        return self.params.get(key, default)


def _parse_params(tokens: List[str]) -> Dict[int, object]:
    out: Dict[int, object] = {}
    for tok in tokens:
        k, v = tok.split("=", 1)
        k = int(k)
        if k < 0:  # array param
            vals = v.split(",")
            arr = [float(x) if "." in x or "e" in x else int(x)
                   for x in vals]
            out[-k - 23300] = arr[1:]  # first entry is the count
        else:
            out[k] = float(v) if ("." in v or "e" in v.lower()) else int(v)
    return out


class _BinReader:
    def __init__(self, blob: bytes):
        self.blob = blob
        self.pos = 0

    def read_tagged(self, count: int) -> np.ndarray:
        tag = int(np.frombuffer(self.blob, "<u4", 1, self.pos)[0])
        self.pos += 4
        if tag == TAG_FP16:
            data = np.frombuffer(self.blob, "<f2", count, self.pos)
            self.pos += (count * 2 + 3) // 4 * 4  # 4-byte aligned
            return data.astype(np.float32)
        if tag in (TAG_FP32, TAG_RAW):
            data = np.frombuffer(self.blob, "<f4", count, self.pos)
            self.pos += count * 4
            return data.astype(np.float32)
        raise ValueError(f"unsupported ncnn weight tag 0x{tag:08x}")

    def read_raw(self, count: int) -> np.ndarray:
        data = np.frombuffer(self.blob, "<f4", count, self.pos)
        self.pos += count * 4
        return data.astype(np.float32)


def load_ncnn(param_path: str, bin_path: str) -> List[NcnnLayer]:
    with open(param_path) as f:
        lines = [l.split() for l in f.read().splitlines() if l.strip()]
    magic = int(lines[0][0])
    if magic != 7767517:
        raise ValueError(f"bad ncnn magic {magic}")
    layer_count, _blob_count = int(lines[1][0]), int(lines[1][1])
    layers: List[NcnnLayer] = []
    for row in lines[2:2 + layer_count]:
        ltype, name, nin, nout = row[0], row[1], int(row[2]), int(row[3])
        ins = row[4:4 + nin]
        outs = row[4 + nin:4 + nin + nout]
        params = _parse_params(row[4 + nin + nout:])
        layers.append(NcnnLayer(ltype, name, ins, outs, params))

    reader = _BinReader(open(bin_path, "rb").read())
    for layer in layers:
        if layer.type == "Convolution":
            wsize = layer.p(6)
            layer.weights["weight"] = reader.read_tagged(wsize)
            if layer.p(5, 0):
                layer.weights["bias"] = reader.read_raw(layer.p(0))
    if reader.pos != len(reader.blob):
        raise ValueError(
            f"ncnn bin not fully consumed: {reader.pos}/{len(reader.blob)}")
    return layers


def load_npz(path: str) -> List[NcnnLayer]:
    """A layer graph vendored as one .npz (a JSON graph plus float16 conv
    weights and float32 biases; ``mpmvs_tpu.models.ncnn.save_npz`` writes
    it)."""
    import json

    z = np.load(path)
    meta = json.loads(bytes(z["__graph__"]).decode())
    layers = []
    for i, m in enumerate(meta):
        layer = NcnnLayer(m["type"], m["name"], m["inputs"], m["outputs"],
                          {int(k): v for k, v in m["params"].items()})
        for key in z.files:
            if key.startswith(f"{i}."):
                layer.weights[key.split(".", 1)[1]] = z[key].astype(np.float32)
        layers.append(layer)
    return layers


class NcnnNet(nn.Module):
    """An ncnn layer graph as an ``nn.Module``: (C, H, W) float32 in, the
    ``output_blob`` tensor out. Conv weights and biases are buffers, so
    ``.to(device)`` moves the whole net."""

    def __init__(self, layers: List[NcnnLayer], input_blob: str = "input.1",
                 output_blob: str = "1959"):
        super().__init__()
        self.layers = layers
        self.input_blob = input_blob
        self.output_blob = output_blob
        for i, layer in enumerate(layers):
            if layer.type == "Convolution":
                out_ch = layer.p(0)
                kw = layer.p(1)
                kh = layer.p(11, kw)
                w = layer.weights["weight"]
                self.register_buffer(f"w{i}", torch.as_tensor(
                    w.reshape(out_ch, w.size // (out_ch * kh * kw), kh, kw)))
                if "bias" in layer.weights:
                    self.register_buffer(f"b{i}", torch.as_tensor(
                        layer.weights["bias"]))

    def _conv(self, i: int, x: torch.Tensor, layer: NcnnLayer) -> torch.Tensor:
        dil = layer.p(2, 1)
        stride = layer.p(3, 1)
        pad_l = layer.p(4, 0)
        pad_t = layer.p(14, pad_l)
        pad_r = layer.p(15, pad_l)
        pad_b = layer.p(16, pad_t)
        x = F.pad(x[None], (pad_l, pad_r, pad_t, pad_b))
        y = F.conv2d(x, getattr(self, f"w{i}"), getattr(self, f"b{i}", None),
                     stride=(stride, layer.p(13, stride)),
                     dilation=(dil, layer.p(12, dil)))[0]
        act = layer.p(9, 0)
        if act == 1:
            y = torch.relu(y)
        elif act == 4:
            y = torch.sigmoid(y)
        elif act != 0:
            raise NotImplementedError(f"conv activation {act}")
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return self._run(x)

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        blobs = {self.input_blob: x}
        for i, layer in enumerate(self.layers):
            if layer.type == "Input":
                continue
            ins = [blobs[b] for b in layer.inputs]
            if layer.type == "Convolution":
                out = [self._conv(i, ins[0], layer)]
            elif layer.type == "Split":
                out = [ins[0]] * len(layer.outputs)
            elif layer.type == "Concat":
                out = [torch.cat(ins, layer.p(0, 0))]
            elif layer.type == "Pooling":
                if layer.p(0, 0) != 0:
                    raise NotImplementedError("only max pooling")
                k = layer.p(1, 2)
                out = [F.max_pool2d(ins[0][None], k, layer.p(2, k))[0]]
            elif layer.type == "Interp":
                oh, ow = layer.p(3), layer.p(4)
                if oh <= 0 or ow <= 0:
                    sh, sw = layer.p(1, 1.0), layer.p(2, 1.0)
                    oh = int(round(ins[0].shape[1] * float(sh)))
                    ow = int(round(ins[0].shape[2] * float(sw)))
                h, w = ins[0].shape[1:]
                out = [F.interpolate(ins[0][None], size=(oh, ow),
                                     mode="bilinear", align_corners=False,
                                     antialias=oh < h or ow < w)[0]]
            elif layer.type == "BinaryOp":
                op = layer.p(0, 0)
                if op == 0:
                    out = [ins[0] + ins[1]]
                elif op == 2:
                    out = [ins[0] * ins[1]]
                else:
                    raise NotImplementedError(f"BinaryOp {op}")
            elif layer.type == "Sigmoid":
                out = [torch.sigmoid(ins[0])]
            else:
                raise NotImplementedError(f"ncnn layer {layer.type}")
            for name, val in zip(layer.outputs, out):
                blobs[name] = val
            if layer.outputs == [self.output_blob]:
                break
        return blobs[self.output_blob]
