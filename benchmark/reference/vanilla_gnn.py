"""VanillaNetwork as the reference publishes it (deeprank2's
``neuralnets/gnn/vanilla_gnn.py``): each of two layers sums, onto an edge's
first endpoint, the messages ``relu(W_e [x_i ‖ x_j ‖ e_ij] + b_e)`` (message
size 32) and updates every node to ``relu(W_n [x ‖ message sum] + b_n)``;
then the mean of each graph's nodes and ``W_2 relu(W_1 mean + b_1) + b_2``
(hidden size 128). Edges run both ways, each carrying its features. Plain
PyTorch on a whole batch: the concatenation and one product per edge, the
sums by ``index_add_``."""

from __future__ import annotations

import torch

MESSAGE_SIZE = 32
HIDDEN_SIZE = 128


def parameter_shapes(node_features: int, outputs: int, edge_features: int) -> dict[str, tuple[tuple[int, ...], int]]:
    """Each parameter's shape and fan-in, under the reference's state-dict keys."""
    f, fe = node_features, edge_features
    shapes = {}
    for layer in ("_external1", "_external2"):
        shapes[f"{layer}._edge_mlp.0.weight"] = ((MESSAGE_SIZE, 2 * f + fe), 2 * f + fe)
        shapes[f"{layer}._edge_mlp.0.bias"] = ((MESSAGE_SIZE,), 2 * f + fe)
        shapes[f"{layer}._node_mlp.0.weight"] = ((f, f + MESSAGE_SIZE), f + MESSAGE_SIZE)
        shapes[f"{layer}._node_mlp.0.bias"] = ((f,), f + MESSAGE_SIZE)
    shapes["_graph_mlp.0.weight"] = ((HIDDEN_SIZE, f), f)
    shapes["_graph_mlp.0.bias"] = ((HIDDEN_SIZE,), f)
    shapes["_graph_mlp.2.weight"] = ((outputs, HIDDEN_SIZE), HIDDEN_SIZE)
    shapes["_graph_mlp.2.bias"] = ((outputs,), HIDDEN_SIZE)
    return shapes


def forward(params: dict, batch: dict) -> torch.Tensor:
    """Logits ``[G, outputs]`` of a batch: ``x [V, F]``, ``src``/``dst [E]``
    (both directions of every edge), ``edge_attr [E, Fe]``, ``node_graph
    [V]`` and ``num_graphs``."""
    x, src, dst, e = batch["x"], batch["src"], batch["dst"], batch["edge_attr"]
    for layer in ("_external1", "_external2"):
        w, b = params[f"{layer}._edge_mlp.0.weight"], params[f"{layer}._edge_mlp.0.bias"]
        messages = torch.relu(torch.cat([x[src], x[dst], e], dim=1) @ w.T + b)
        sums = torch.zeros(x.shape[0], MESSAGE_SIZE, dtype=x.dtype, device=x.device).index_add_(0, src, messages)
        wn, bn = params[f"{layer}._node_mlp.0.weight"], params[f"{layer}._node_mlp.0.bias"]
        x = torch.relu(torch.cat([x, sums], dim=1) @ wn.T + bn)
    g = batch["num_graphs"]
    totals = torch.zeros(g, x.shape[1], dtype=x.dtype, device=x.device).index_add_(0, batch["node_graph"], x)
    counts = torch.zeros(g, dtype=x.dtype, device=x.device).index_add_(0, batch["node_graph"], torch.ones_like(x[:, 0]))
    means = totals / counts[:, None]
    hidden = torch.relu(means @ params["_graph_mlp.0.weight"].T + params["_graph_mlp.0.bias"])
    return hidden @ params["_graph_mlp.2.weight"].T + params["_graph_mlp.2.bias"]
