"""The indexing pipeline: parse, resolve, chunk, embed, index."""
