"""VanillaNetwork on residue graphs through the Trainer's COO branch
(``ops/batch.py:collate_graphs``, the row gathers, the sorted segment sum
K7 of ``ops/segment_sorted.py`` and the pools)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import vanilla_gnn as reference


def ragged_rows(offsets: np.ndarray, counts: np.ndarray, graphs: np.ndarray) -> np.ndarray:
    """The flat row indices of ``graphs``' rows, graph after graph."""
    lens = counts[graphs]
    starts = np.repeat(offsets[graphs] - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    return starts + np.arange(int(lens.sum()))

PORT_CLASS = "gnn.vanilla_gnn.VanillaNetwork"
KERNEL_SOURCES = ["segment_sum"]
forward = reference.forward


def parameter_shapes(config: dict) -> dict:
    """The reference's parameters at the configuration's widths; the message
    and hidden sizes are the published model's (and the port's) constants."""
    if (config["message_size"], config["hidden_size"]) != (reference.MESSAGE_SIZE, reference.HIDDEN_SIZE):
        msg = f"VanillaNetwork's message and hidden sizes are {reference.MESSAGE_SIZE} and {reference.HIDDEN_SIZE}"
        raise ValueError(msg)
    return reference.parameter_shapes(config["node_features"], config["outputs"], config["edge_features"])


def batches(inputs, batch_size: int, device: torch.device, order=None):
    """The reference's own batches of the Trainer's chunks (``batch_size``
    graphs after another of ``order``, by default the inputs' order): every
    graph's nodes, each edge both ways."""
    order = np.arange(inputs.count) if order is None else np.asarray(order)
    node_off, edge_off = inputs.node_offsets(), inputs.edge_offsets()

    def each():
        for start in range(0, len(order), batch_size):
            chunk = order[start : start + batch_size]
            counts = inputs.node_counts[chunk]
            nodes = ragged_rows(node_off, inputs.node_counts, chunk)
            edges = ragged_rows(edge_off, inputs.edge_counts, chunk)
            shift = np.concatenate([[0], np.cumsum(counts)[:-1]])
            und = inputs.edges[edges] + np.repeat(shift, inputs.edge_counts[chunk])[:, None]
            ea = torch.from_numpy(inputs.edge_attr[edges]).to(device)
            batch = {
                "x": torch.from_numpy(inputs.x[nodes]).to(device),
                "src": torch.from_numpy(np.concatenate([und[:, 0], und[:, 1]])).to(device),
                "dst": torch.from_numpy(np.concatenate([und[:, 1], und[:, 0]])).to(device),
                "edge_attr": torch.cat([ea, ea]),
                "node_graph": torch.from_numpy(np.repeat(np.arange(len(chunk)), counts)).to(device),
                "num_graphs": len(chunk),
            }
            yield batch, torch.from_numpy(inputs.y[chunk]).to(device)

    return each


def bucket_size(n: int, quantum: int = 128) -> int:
    """The collate's capacity for ``n`` rows: geometric steps of 1.3x snapped
    to the quantum (a frozen copy of ``ops/batch.py:bucket_size``)."""
    n = max(n, 1)
    size = quantum
    while size < n:
        size = int(np.ceil(size * 1.3 / quantum) * quantum)
    return size


def batch_info(inputs, batch_size: int) -> list[dict]:
    """Each batch's graphs, real nodes, real directed edges and the node
    capacity its collate pads to."""
    info = []
    for start in range(0, inputs.count, batch_size):
        stop = min(start + batch_size, inputs.count)
        nodes = int(inputs.node_counts[start:stop].sum())
        info.append({"graphs": stop - start, "nodes": nodes, "edges": 2 * int(inputs.edge_counts[start:stop].sum()), "node_capacity": bucket_size(nodes)})
    return info


def flops(config: dict, info: dict, train: bool) -> float:
    """Model operations of one batch: the forward, and for a train step its
    weight gradients and the data gradients that the model needs (not those
    of the input features). The node parts of each edge product are taken
    once a node, as the least the model needs; sums and adds count one
    operation an element."""
    f, fe, m, h, o = config["node_features"], config["edge_features"], reference.MESSAGE_SIZE, reference.HIDDEN_SIZE, config["outputs"]
    v, e, g = info["nodes"], info["edges"], info["graphs"]
    total = 0.0
    for layer in (1, 2):
        node_parts, edge_part, node_mlp_x, node_mlp_sums = 2 * v * 2 * f * m, 2 * e * fe * m, 2 * v * f * f, 2 * v * m * f
        elementwise = 2 * e * m + e * m  # the message adds and the segment sum
        products = node_parts + edge_part + node_mlp_x + node_mlp_sums
        total += products + elementwise
        if train:
            data_grads = node_mlp_sums + (node_parts + node_mlp_x if layer == 2 else 0)
            total += products + data_grads + elementwise
    head = 2 * g * (f * h + h * o) + v * f
    total += head * (3 if train else 1)
    return float(total)


def k7_calls(info: dict) -> list[dict]:
    """K7 (``segment_sum_sorted_kernel``) calls of one forward: one a layer,
    summing 32-wide messages of every real edge into the node capacity.
    Bytes as ``chip_smoke.py:time_segment_calls`` counts them: the valid
    messages (4 F) and their row ids (4) read once, the output written once;
    operations, one add a message element."""
    f, e, n = reference.MESSAGE_SIZE, info["edges"], info["node_capacity"]
    return [{"bytes": (4 * f + 4) * e + 4 * f * n, "flop": f * e}] * 2
