"""Copy of `codegraph_tpu/mcp/__init__.py` for the PyTorch port.

MCP serving surface: protocol server, graph tools, agents, LLM providers.

Re-implements the reference's serving crates: codegraph-mcp-server
(official_server.rs 4 consolidated agentic tools + stdio/HTTP
transports), codegraph-mcp-tools (GraphToolExecutor 8 tools),
codegraph-mcp-rig / -autoagents (ReAct / LATS / Reflexion agents),
codegraph-ai (LLM provider zoo), codegraph-mcp-core (context tiers,
debug logger, process management).
"""

from codegraph_tpu_torch.mcp.tiers import ContextTier, tier_limits
from codegraph_tpu_torch.mcp.tools import GraphToolExecutor, TOOL_SCHEMAS
from codegraph_tpu_torch.mcp.server import MCPServer

__all__ = [
    "ContextTier",
    "tier_limits",
    "GraphToolExecutor",
    "TOOL_SCHEMAS",
    "MCPServer",
]
