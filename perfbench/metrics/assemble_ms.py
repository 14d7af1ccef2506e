"""Phase-1 sampler (models/graphdit/api.py GraphDiT.generate): the mean
wall of assembling a sampled batch of graphs into SMILES on the host
(chem/assemble.py graph_to_smiles), in ms; program spans
graphdit.assemble of the traced batch."""

from perfbench import spans


def read(run):
    return spans.span_mean(spans.snapshot(), "graphdit.assemble")
