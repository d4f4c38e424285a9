"""Artifact I/O: the h5 mask and feature files, the vocabulary files."""
