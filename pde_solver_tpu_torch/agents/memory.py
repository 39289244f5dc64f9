"""Conversation memory: message history + simulation records, JSON-persisted.

Contract-compatible with the reference memory subsystem
(conversation_memory.py:15-256): capped message history
(50), last-10 simulation records, ``current_simulation`` used for follow-up
detection/merging, context summaries for the parser prompt, and JSON
save/load with defensive guards.  No LangChain message classes — plain
role/content dicts.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, List, Optional


@dataclass
class SimulationRecord:
    """One completed simulation (conversation_memory.py:15-36)."""

    timestamp: str
    user_query: str
    pde_params: Optional[Dict[str, Any]] = None
    solver_result: Optional[Dict[str, Any]] = None
    html_path: Optional[str] = None
    data_file: Optional[str] = None
    summary: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "timestamp": self.timestamp,
            "user_query": self.user_query,
            "pde_params": self.pde_params,
            "solver_result": self.solver_result,
            "html_path": self.html_path,
            "data_file": self.data_file,
            "summary": self.summary,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SimulationRecord":
        return cls(
            timestamp=str(d.get("timestamp", "")),
            user_query=str(d.get("user_query", "")),
            pde_params=d.get("pde_params"),
            solver_result=d.get("solver_result"),
            html_path=d.get("html_path"),
            data_file=d.get("data_file"),
            summary=d.get("summary"),
        )


class ConversationMemory:
    """Message history (max 50) + simulation records (last 10)."""

    def __init__(self, max_messages: int = 50, persist_file: Optional[str] = None):
        self.max_messages = max_messages
        self.persist_file = persist_file
        self.messages: List[Dict[str, str]] = []
        self.simulation_history: List[SimulationRecord] = []
        self.current_simulation: Optional[SimulationRecord] = None
        if persist_file and os.path.isfile(persist_file):
            self.load()

    # ------------------------------------------------------------------
    def add_message(self, role: str, content: str) -> None:
        self.messages.append({"role": role, "content": content})
        if len(self.messages) > self.max_messages:
            system = [m for m in self.messages if m["role"] == "system"]
            rest = [m for m in self.messages if m["role"] != "system"]
            keep = self.max_messages - len(system)
            self.messages = system + rest[-keep:]

    def add_user_message(self, content: str) -> None:
        self.add_message("user", content)

    def add_ai_message(self, content: str) -> None:
        self.add_message("assistant", content)

    # ------------------------------------------------------------------
    def record_simulation(self, user_query: str,
                          pde_params: Optional[Dict[str, Any]] = None,
                          solver_result: Optional[Dict[str, Any]] = None,
                          html_path: Optional[str] = None,
                          data_file: Optional[str] = None,
                          summary: Optional[str] = None) -> None:
        record = SimulationRecord(
            timestamp=datetime.now().isoformat(),
            user_query=user_query,
            pde_params=pde_params,
            solver_result=solver_result,
            html_path=html_path,
            data_file=data_file,
            summary=summary,
        )
        self.simulation_history.append(record)
        self.current_simulation = record
        if len(self.simulation_history) > 10:
            self.simulation_history = self.simulation_history[-10:]

    def get_context_summary(self) -> str:
        """Human-readable context block for the parser prompt."""
        if not self.simulation_history and not self.messages:
            return ""
        parts: List[str] = []
        if self.current_simulation:
            parts.append("## Most Recent Simulation")
            parts.append(f"Query: {self.current_simulation.user_query}")
            if self.current_simulation.pde_params:
                parts.append("Parameters: "
                             + json.dumps(self.current_simulation.pde_params, default=str))
            if self.current_simulation.summary:
                parts.append(f"Summary: {self.current_simulation.summary}")
        if self.messages:
            parts.append("## Recent Messages")
            for m in self.messages[-6:]:
                parts.append(f"{m['role']}: {m['content'][:200]}")
        return "\n".join(parts)

    def clear(self) -> None:
        self.messages = []
        self.simulation_history = []
        self.current_simulation = None
        if self.persist_file and os.path.isfile(self.persist_file):
            try:
                os.remove(self.persist_file)
            except OSError:
                pass

    # ------------------------------------------------------------------
    def save(self) -> None:
        if not self.persist_file:
            return
        try:
            payload = {
                "messages": self.messages,
                "simulation_history": [r.to_dict() for r in self.simulation_history],
                "current_simulation": (self.current_simulation.to_dict()
                                       if self.current_simulation else None),
            }
            with open(self.persist_file, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=2, default=str)
        except OSError:
            pass  # persistence is best-effort (reference guards :186-201)

    def load(self) -> None:
        if not (self.persist_file and os.path.isfile(self.persist_file)):
            return
        try:
            with open(self.persist_file, encoding="utf-8") as f:
                payload = json.load(f)
            self.messages = [m for m in payload.get("messages", [])
                             if isinstance(m, dict) and "role" in m and "content" in m]
            self.simulation_history = [
                SimulationRecord.from_dict(r)
                for r in payload.get("simulation_history", [])
                if isinstance(r, dict)
            ]
            cur = payload.get("current_simulation")
            self.current_simulation = SimulationRecord.from_dict(cur) if cur else None
        except (OSError, json.JSONDecodeError, KeyError, TypeError):
            # Corrupt memory file → start fresh (reference behavior :208-256)
            self.messages = []
            self.simulation_history = []
            self.current_simulation = None
