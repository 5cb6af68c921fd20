"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: they skip without a CUDA device. They import no JAX, so on a
GPU machine without JAX run them without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import pytest
import torch

from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
from deeprank2_tpu_torch.ops import diag_spmm as ds
from deeprank2_tpu_torch.ops.batch import collate_graphs_dense
from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
from deeprank2_tpu_torch.ops.synthetic import synthetic_entries

pytestmark = pytest.mark.cuda
TOL = {"rtol": 1e-5, "atol": 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(g, n, f, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    adj = torch.rand(g, n, n, generator=gen) < 0.1
    adj = adj | adj.transpose(1, 2)
    mask = torch.ones(g, n, dtype=torch.bool)
    mask[:, n - n // 5 :] = False
    adj &= mask[:, :, None] & mask[:, None, :]
    x = torch.randn(f, g * n, generator=gen)
    g_pool = torch.randn(f, g, generator=gen)
    return adj.to(torch.int8).to(dev), mask.to(dev), x.to(dev), g_pool.to(dev)


# N=416 needs more than 48 KB of dynamic shared memory; F=70 leaves a ragged feature chunk
@pytest.mark.parametrize(("g", "n", "f"), [(3, 32, 8), (5, 100, 70), (2, 416, 33)])
def test_kernels_match_plain_versions(cuda, g, n, f) -> None:
    adj, mask, x, g_pool = _operands(g, n, f, cuda)
    torch.testing.assert_close(ds.diag_kernel(adj, x), ds.diag_kernel_ref(adj, x), **TOL)
    h = ds.diag_kernel_ref(adj, x, mask, "relu_mask")
    torch.testing.assert_close(ds.diag_kernel(adj, x, mask, "relu_mask"), h, **TOL)
    sign, pooled = ds.diag_kernel(adj, x, mask, "relu_mask_pool")
    sign_ref, pooled_ref = ds.diag_kernel_ref(adj, x, mask, "relu_mask_pool")
    torch.testing.assert_close(pooled, pooled_ref, **TOL)
    assert not ((sign != sign_ref) & (h.abs() > TOL["atol"])).any()
    torch.testing.assert_close(ds.pool_bwd_kernel(adj, sign_ref, g_pool), ds.pool_bwd_kernel_ref(adj, sign_ref, g_pool), **TOL)


def test_kernel_raises_on_nodes_beyond_shared_memory(cuda) -> None:
    adj, _, x, _ = _operands(1, 2048, 4, cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ds.diag_kernel(adj, x)


def test_train_step_matches_cpu_and_counts_launches(cuda) -> None:
    entries = synthetic_entries(6, 40, 38, 6, seed=2)
    batch, _ = collate_graphs_dense(entries, pad_graphs=8, pad_nodes=64, device=cuda)
    model = GINetDense(38, 2, 6, device=cuda)
    cpu_model = GINetDense(38, 2, 6, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    loss_fn = CrossEntropyLoss()
    ds.reset_launches()
    loss = loss_fn(model(batch), batch.y, batch.y_mask)
    loss.backward()
    assert ds.launches == {"diag_kernel": 3, "pool_bwd_kernel": 1}
    cpu_batch = batch.to("cpu")
    cpu_loss = loss_fn(cpu_model(cpu_batch), cpu_batch.y, cpu_batch.y_mask)
    cpu_loss.backward()
    torch.testing.assert_close(loss.detach().cpu(), cpu_loss.detach(), rtol=1e-4, atol=1e-6)
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        if p.grad is None:
            assert q.grad is None, name
        else:
            torch.testing.assert_close(p.grad.cpu(), q.grad, rtol=1e-4, atol=1e-6, msg=name)
