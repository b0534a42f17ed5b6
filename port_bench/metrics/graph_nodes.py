"""Nodes of the per-instance engine's captured step program
(`solver/capture.py::Program.nodes`)."""


def read(rec):
    return rec.get("graph_nodes")
