"""Copy of `codegraph_tpu/version.py` for the PyTorch port."""

__version__ = "0.1.0"

# MCP protocol version we speak (matches reference codegraph-mcp-core/src/version.rs)
MCP_PROTOCOL_VERSION = "2024-11-05"
