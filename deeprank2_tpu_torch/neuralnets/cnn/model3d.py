"""3D CNNs on grid-mapped features (port of
``deeprank2_tpu/neuralnets/cnn/model3d.py``; reference:
neuralnets/cnn/model3d.py).

Conv3d(F→4, k2), relu, max-pool 2, Conv3d(4→5, k2), relu, max-pool 2,
then FC(84), relu, FC(out). The convolutions and pools are PyTorch's
(cuDNN on the card, in float32: ``neuralnets/nn.py:conv3d``); the JAX
package computes them with XLA, outside any Pallas kernel. The flattened
size of the FC input is computed from the box, as in the JAX package, with
no dummy forward.
"""

from __future__ import annotations

import torch
from torch import nn

from deeprank2_tpu_torch.device import resolve_device
from deeprank2_tpu_torch.neuralnets import nn as dnn
from deeprank2_tpu_torch.ops.batch import GridBatch


def _after_conv_pool(dim: int, ksize: int = 2, pool: int = 2) -> int:
    return (dim - (ksize - 1)) // pool


class _Cnn3dBase(nn.Module):
    """The two CNNs' layers, under the reference's parameter names
    (``convlayer_000``, ``convlayer_002``, ``fclayer_000``, ``fclayer_001``),
    which ``neuralnets/param_interop.py`` maps to the JAX tree with
    ``family="cnn"``. ``generator`` draws the initial weights (a fixed seed
    when None)."""

    needs_clusters = False  # Trainer dispatch (JAX model3d.py:23)

    def __init__(
        self,
        num_features: int,
        box_shape: tuple[int, int, int],
        output_shape: int,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.num_features = num_features
        self.box_shape = tuple(box_shape)
        self.output_shape = output_shape
        dims = [_after_conv_pool(_after_conv_pool(d)) for d in self.box_shape]
        self.flat_size = 5 * dims[0] * dims[1] * dims[2]
        self.convlayer_000 = dnn.init_conv3d(num_features, 4, 2, generator=gen, device=dev)
        self.convlayer_002 = dnn.init_conv3d(4, 5, 2, generator=gen, device=dev)
        self.fclayer_000 = dnn.init_linear(self.flat_size, 84, generator=gen, device=dev)
        self.fclayer_001 = dnn.init_linear(84, output_shape, generator=gen, device=dev)

    def forward(self, batch: GridBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:  # noqa: ARG002
        """Outputs ``[G, output_shape]`` of a :class:`GridBatch` (``x [G, C,
        W, H, D]``). No dropout, so ``training`` and ``generator`` change
        nothing."""
        x = dnn.max_pool3d(dnn.relu(dnn.conv3d(self.convlayer_000, batch.x)))
        x = dnn.max_pool3d(dnn.relu(dnn.conv3d(self.convlayer_002, x)))
        x = dnn.relu(dnn.linear(self.fclayer_000, x.reshape(x.shape[0], -1)))
        return dnn.linear(self.fclayer_001, x)


class CnnRegression(_Cnn3dBase):
    """3D CNN predicting one continuous value per grid."""

    def __init__(self, num_features: int, box_shape: tuple[int, int, int], device: str | torch.device | None = None, generator: torch.Generator | None = None):
        super().__init__(num_features, box_shape, 1, device, generator)


class CnnClassification(_Cnn3dBase):
    """3D CNN predicting two-class logits per grid."""

    def __init__(self, num_features: int, box_shape: tuple[int, int, int], device: str | torch.device | None = None, generator: torch.Generator | None = None):
        super().__init__(num_features, box_shape, 2, device, generator)
