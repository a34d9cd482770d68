"""Vector indexes: the flat exact index and its snapshots."""
