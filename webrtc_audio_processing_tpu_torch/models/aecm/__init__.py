"""AECM: the fixed-point mobile echo canceller."""
