"""ReAct conversation agent orchestrating the audio tools.

Copy of ``audiogpt_tpu/agent/agent.py:1-159`` (pure Python). Functional
re-design of the reference's ``ConversationBot``
(``audio-chatgpt.py:1051-1374``): the same Thought/Action/Action Input/
Observation protocol and audio-file-path discipline, without LangChain — the
loop is ~60 lines, testable against :class:`ScriptedLLM`.

Parity points:
  * history truncation to the last ~500 words (``cut_dialogue_history``:77),
  * intermediate-step capture so the caller can route generated files to the
    right UI pane (``run_text`` branches at 1210-1248),
  * the speech loop: ASR → agent → TTS of the response, merged with any
    generated audio (``ConversationBot.speech``:1294-1344).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable

from audiogpt_tpu_torch.agent.llm import LLMClient, LLMUnavailable
from audiogpt_tpu_torch.agent.tools import ToolRegistry

PREFIX = """You are an audio dialogue assistant with tools for speech, audio,
and singing-voice tasks. You cannot hear audio directly; audio is referenced
by file names of the form "audio/xxx.wav". Be strict about file names: never
invent a file that no tool produced, and always report the file name from the
last tool observation when a new audio is generated.

TOOLS:
------
You have access to the following tools:
{tool_descriptions}
"""

FORMAT_INSTRUCTIONS = """To use a tool, reply in this exact format:

Thought: Do I need to use a tool? Yes
Action: the tool to use, one of [{tool_names}]
Action Input: the input to the tool
Observation: the tool's result

When you have a final answer (or need no tool), reply:

Thought: Do I need to use a tool? No
AI: [your response here]
"""

SUFFIX = """Previous conversation history:
{chat_history}
New input: {input}
Thought: Do I need to use a tool? {scratchpad}"""


def cut_dialogue_history(history: str, keep_last_n_words: int = 500) -> str:
    tokens = history.split()
    if len(tokens) < keep_last_n_words:
        return history
    paragraphs = history.split("\n")
    n = len(tokens)
    while n >= keep_last_n_words and paragraphs:
        n -= len(paragraphs[0].split(" "))
        paragraphs = paragraphs[1:]
    return "\n" + "\n".join(paragraphs)


@dataclasses.dataclass
class AgentResult:
    response: str
    steps: list[tuple[str, str, str]]  # (tool, input, observation)

    @property
    def last_file(self) -> str | None:
        for _, _, obs in reversed(self.steps):
            m = re.search(r"\b((?:audio|image|video)/[\w.-]+)", obs)
            if m:
                return m.group(1)
        m = re.search(r"\b((?:audio|image|video)/[\w.-]+)", self.response)
        return m.group(1) if m else None


class ConversationAgent:
    def __init__(self, llm: LLMClient, tools: ToolRegistry,
                 max_steps: int = 6, keep_last_n_words: int = 500):
        self.llm = llm
        self.tools = tools
        self.max_steps = max_steps
        self.keep_last_n_words = keep_last_n_words
        self.history = ""

    # -- core ReAct loop ----------------------------------------------------
    def run_text(self, text: str) -> AgentResult:
        self.history = cut_dialogue_history(self.history, self.keep_last_n_words)
        scratchpad = ""
        steps: list[tuple[str, str, str]] = []
        for _ in range(self.max_steps):
            prompt = (
                PREFIX.format(tool_descriptions=self.tools.descriptions())
                + FORMAT_INSTRUCTIONS.format(tool_names=", ".join(self.tools.names()))
                + SUFFIX.format(chat_history=self.history, input=text,
                                scratchpad=scratchpad)
            )
            try:
                out = self.llm.complete(prompt, stop=["\nObservation:"])
            except LLMUnavailable as e:
                # endpoint down after all retries: a chat-visible apology,
                # not a 500 (history untouched so the turn can be retried)
                return AgentResult(
                    response=f"The language model is unavailable right now "
                             f"({e}). Please try again.", steps=steps)
            action = re.search(r"Action:\s*(.+)", out)
            action_input = re.search(r"Action Input:\s*(.+)", out)
            final = re.search(r"AI:\s*(.*)", out, re.S)
            if action and action_input and action.group(1).strip() in self.tools:
                tool_name = action.group(1).strip()
                arg = action_input.group(1).strip()
                try:
                    obs = self.tools.get(tool_name)(arg)
                except Exception as e:  # surface tool errors as observations
                    obs = f"Tool error: {e}"
                steps.append((tool_name, arg, obs))
                scratchpad += f"{out.strip()}\nObservation: {obs}\nThought: Do I need to use a tool? "
                continue
            response = final.group(1).strip() if final else out.strip()
            self.history += f"\nHuman: {text}\nAI: {response}"
            return AgentResult(response=response, steps=steps)
        response = "I could not finish within the step limit."
        self.history += f"\nHuman: {text}\nAI: {response}"
        return AgentResult(response=response, steps=steps)

    # -- media ingestion (reference run_image_or_audio, 1250-1292) ----------
    def ingest_audio(self, path: str, describe: Callable[[str], str] | None = None):
        desc = describe(path) if describe else "an audio clip"
        self.history += (
            f"\nHuman: provide a new audio file named {path}. "
            f"The description is: {desc}. Understand the audio and answer "
            f"from the file, not the description.\nAI: Received."
        )

    # -- speech loop (reference speech(), 1294-1344) ------------------------
    def speech(self, wav_path: str, asr: Callable[[str], str],
               tts: Callable[[str], str],
               merge: Callable[[str, str], str] | None = None) -> tuple[str, str]:
        """ASR the input, run the agent, TTS the response; if a tool made
        audio, merge speech + generated audio. Returns (response_text,
        output_audio_path)."""
        text = asr(wav_path)
        result = self.run_text(text)
        speech_path = tts(result.response)
        out_path = speech_path
        gen = result.last_file
        if gen and gen.startswith("audio/") and merge is not None:
            out_path = merge(speech_path, gen)
        return result.response, out_path
