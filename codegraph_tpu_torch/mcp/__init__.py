"""MCP serving surface: the graph tools (the protocol server, agents and LLM
providers of `codegraph_tpu/mcp/` wait for ROADMAP item 18)."""
