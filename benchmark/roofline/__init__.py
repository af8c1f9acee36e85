"""Work counts: model FLOPs from layer shapes, the hand kernels' bounds."""
