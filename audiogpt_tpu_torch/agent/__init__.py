"""The agent: typed tool registry, LLM clients, the ReAct loop and the
default toolset over the port's engines; exports as
``audiogpt_tpu/agent/__init__.py:1-3``."""

from audiogpt_tpu_torch.agent.tools import Tool, ToolRegistry, new_media_path  # noqa: F401
from audiogpt_tpu_torch.agent.llm import LLMClient, ScriptedLLM, OpenAICompatLLM  # noqa: F401
from audiogpt_tpu_torch.agent.agent import ConversationAgent, AgentResult  # noqa: F401
