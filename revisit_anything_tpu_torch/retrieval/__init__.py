"""Segment matches → image predictions (rank fusion) and Recall@K."""
