"""Multi-device parallelism: device meshes and sharding helpers.

Counterpart of ``nnc_tpu/parallel/__init__.py``. The LSA hot loop and the
deterministic renders are data-parallel over rays: the ray batch is split
over the ``data`` axis while the models replicate (they are small), so the
only collective is the sum of the gradients. A ``model`` axis shards the
MLP's hidden width (``ops/mlp_tp_fused.py``).

JAX gives the reference one process that sees N devices. The port keeps that
shape: one process and a :class:`Mesh` of ``torch.device`` s with named axes,
in which a device may appear more than once. A mesh of M x ``cuda:0`` is the
counterpart of the reference's virtual CPU mesh: the same program, sharded,
on one card. On a machine with several GPUs the same code places the shards
on distinct devices. Collectives are explicit and deterministic:
:func:`psum` adds the shards' tensors in mesh order on the group's first
device and copies the sum back to each distinct device.

There is no ``torch.distributed`` / NCCL path: it needs one process per GPU
and more than one GPU to run at all, and the port's target and every machine
it has been run on has one (ROADMAP queue A).
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.device import require_cuda


def _device(d) -> torch.device:
    """``d`` as the device a tensor moved to it reports: ``cuda`` names the
    current CUDA device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An array of ``torch.device`` s with one name per axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        arr.reshape(-1)[:] = [_device(d)
                              for d in np.asarray(devices, dtype=object)
                              .reshape(-1)]
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim} mesh axes, names {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis: the
        group that shares the work split over that axis."""
        index = tuple(slice(None) if name == axis else 0
                      for name in self.axis_names)
        return list(self.devices[index])

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """Create a device mesh. ``devices``: the devices to lay out, repeated
    cyclically up to ``n_devices``; None means the CUDA devices PyTorch sees
    (an error where there is none). Defaults to one 'data' axis; with two
    axes and no ``shape`` the second gets the smallest of 2, 4, 8 that
    divides the device count (the reference's rule)."""
    if devices is None:
        require_cuda()
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = len(devices) if n_devices is None else int(n_devices)
    devices = [devices[i % len(devices)] for i in range(n)]
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        elif len(axes) == 2:
            m = next((c for c in (2, 4, 8) if n % c == 0 and c <= n), 1)
            shape = (n // m, m)
        else:
            raise ValueError("give an explicit shape for >2 axes")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {n} "
                         f"devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axes)


def data_devices(mesh: Mesh) -> List[torch.device]:
    """The devices a ray batch is split over: the 'data' axis, or the
    mesh's first device alone when it has no such axis."""
    if "data" in mesh.axis_names:
        return mesh.axis_devices("data")
    return [mesh.devices.flat[0]]


def _split(t: torch.Tensor, devices, dim: int):
    if t.shape[dim] % len(devices):
        raise ValueError(f"axis {dim} of size {t.shape[dim]} does not divide "
                         f"over {len(devices)} devices")
    return [part.to(d) for part, d in
            zip(torch.chunk(t, len(devices), dim=dim), devices)]


def shard_train_inputs(mesh: Mesh, *arrays):
    """Split each array's leading (ray) axis over 'data': per array a list
    with one float32 tensor per data device, equal parts in ray order."""
    devices = data_devices(mesh)
    return tuple(_split(torch.as_tensor(a, dtype=torch.float32), devices, 0)
                 for a in arrays)


def shard_scan_inputs(mesh: Mesh, packed):
    """Split a (K, N, 12) stack of K packed ray batches over 'data' along
    its ray axis (axis 1): one (K, N / D, 12) tensor per data device. The
    step axis K stays whole on every device. (The reference also places the
    K steps' PRNG keys; the port's draws come from a generator or from the
    trainer's ``draws``.)"""
    return _split(torch.as_tensor(packed, dtype=torch.float32),
                  data_devices(mesh), 1)


def replicate_params(mesh: Mesh, model) -> Dict[torch.device, torch.nn.Module]:
    """One replica of ``model`` per distinct device of the mesh: ``model``
    itself on its own device, a deep copy moved to each other one. A device
    that the mesh repeats gets one replica."""
    replicas = {}
    for d in mesh.devices.flat:
        if d not in replicas:
            replicas[d] = model if model.device == d \
                else copy.deepcopy(model).to(d)
    return replicas


def shard_params_tp(mesh: Mesh, model) -> List[Dict[str, torch.Tensor]]:
    """Tensor-parallel placement of a NeRF's tensors: per device of the
    'model' axis a dict ``{"<layer>.weight" (in, out / M), "<layer>.bias"
    (out / M,)}`` holding that device's slice of every layer's output
    dimension where M divides it, else the whole tensor (weights in the
    reference's (in, out) layout, LSA scales folded in)."""
    devices = mesh.axis_devices("model") if "model" in mesh.axis_names \
        else [mesh.devices.flat[0]]
    m = len(devices)
    out = [{} for _ in devices]
    with torch.no_grad():
        for name, layer in model.layers().items():
            w, b = layer.effective_weight().t(), layer.bias
            split = w.shape[1] % m == 0
            for i, d in enumerate(devices):
                cols = slice(i * w.shape[1] // m, (i + 1) * w.shape[1] // m) \
                    if split else slice(None)
                out[i][name + ".weight"] = w[:, cols].to(d, copy=True) \
                    .contiguous()
                out[i][name + ".bias"] = b[cols].to(d, copy=True)
    return out


def psum(parts: Sequence[torch.Tensor], devices: Sequence[torch.device]):
    """The sum of one tensor per shard, ``parts[i]`` on ``devices[i]``:
    added in shard order on the first device, then copied to each distinct
    device. Returns {device: sum}."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(devices[0])
    return {d: total.to(d) for d in dict.fromkeys(devices)}
