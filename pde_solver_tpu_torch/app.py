#!/usr/bin/env python
"""Chat front end of the PyTorch/CUDA port.

* ``streamlit run pde_solver_tpu_torch/app.py`` — web chat UI (chat
  history, example buttons, embedded interactive plots, download buttons,
  clear-memory), when streamlit is installed.
* ``python -m pde_solver_tpu_torch.app --cli`` (or no streamlit available)
  — terminal chat loop.

The solves run on the card; ``PDE_TPU_DEVICE=cpu PDE_TPU_PRECISION=mixed``
sends them to the CPU.  Works without an OPENAI_API_KEY: the parser falls
back to rule-based extraction.
"""

from __future__ import annotations

import asyncio
import os
import sys

if __package__ in (None, ""):
    # run as a script (``streamlit run pde_solver_tpu_torch/app.py``): the
    # package is imported from its parent directory
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

EXAMPLES = [
    "Solve 1D heat transfer in a 2 meter rod, left end at 20°C, right end at 0°C",
    "Simulate heat diffusion in a 1m x 1m plate with initial temperature 10°C",
    "Steady heat conduction in a cylinder with inner radius 0.1 m and outer radius 1 m, inner surface at 100°C, outer at 20°C",
    "Solve 2D elasticity on a 1m x 1m plate with Young's modulus 210 GPa and gravity",
    "3D elasticity problem on a 1m x 0.2m x 0.2m box with gravity",
    "A steel sphere of diameter 10 cm quenched from 800°C to 20°C water with h = 500",
    "Stress in a 2 m x 0.2 m steel cantilever, E 200 GPa, with a downward tip load of 1 kN at the free end",
    "First 4 natural frequencies of a 2 m x 0.3 m x 0.3 m steel beam",
    "Pollutant transport in a 2 m channel with flow speed 1.5 m/s and diffusivity 0.02",
]


def _new_orchestrator():
    from pde_solver_tpu_torch.agents.orchestrator import MultiAgentOrchestrator
    return MultiAgentOrchestrator()


def run_streamlit() -> None:
    import streamlit as st
    import streamlit.components.v1 as components

    st.set_page_config(page_title="PDE Solver (CUDA)", page_icon="🌡️", layout="wide")
    st.title("PDE Solver — PyTorch/CUDA")

    if "orchestrator" not in st.session_state:
        st.session_state.orchestrator = _new_orchestrator()
        st.session_state.history = []

    with st.sidebar:
        st.markdown("**Examples**")
        for ex in EXAMPLES:
            if st.button(ex, key=ex):
                st.session_state.pending = ex
        if st.button("Clear memory"):
            st.session_state.orchestrator.clear_memory()
            st.session_state.history = []
            st.rerun()

    def _downloads(entry, idx):
        """Visualization HTML + data-pickle download buttons (reference
        app.py:236-264 behavior: two columns when both artifacts exist)."""
        html_path = entry.get("html_path")
        data_file = entry.get("data_file")
        if not (html_path and os.path.exists(html_path)):
            return
        if data_file and os.path.exists(data_file):
            col1, col2 = st.columns(2)
            with col1:
                with open(html_path, "rb") as f:
                    st.download_button(
                        label="📥 Download Visualization HTML", data=f.read(),
                        file_name=os.path.basename(html_path), mime="text/html",
                        key=f"download_html_{idx}", use_container_width=True)
            with col2:
                with open(data_file, "rb") as f:
                    st.download_button(
                        label="📥 Download Data (Pickle)", data=f.read(),
                        file_name=os.path.basename(data_file),
                        mime="application/octet-stream",
                        key=f"download_data_{idx}", use_container_width=True)
        else:
            with open(html_path, "rb") as f:
                st.download_button(
                    label="📥 Download Visualization HTML", data=f.read(),
                    file_name=os.path.basename(html_path), mime="text/html",
                    key=f"download_html_{idx}", use_container_width=True)

    for idx, entry in enumerate(st.session_state.history):
        with st.chat_message(entry["role"]):
            st.markdown(entry["content"])
            if entry.get("html_path") and os.path.exists(entry["html_path"]):
                with open(entry["html_path"]) as f:
                    components.html(f.read(), height=650, scrolling=True)
                _downloads(entry, idx)

    prompt = st.chat_input("Describe a PDE problem...") or st.session_state.pop("pending", None)
    if prompt:
        st.session_state.history.append({"role": "user", "content": prompt})
        with st.spinner("Solving..."):
            result = asyncio.run(st.session_state.orchestrator.solve(prompt))
        reply = str(result.get("summary") or result.get("response")
                    or result.get("error") or result)
        st.session_state.history.append({
            "role": "assistant", "content": reply,
            "html_path": result.get("html_path"),
            "data_file": result.get("data_file"),
        })
        st.rerun()


def main() -> None:
    if "--cli" not in sys.argv:
        try:
            import streamlit  # noqa: F401
            import streamlit.runtime

            if streamlit.runtime.exists():
                run_streamlit()
                return
            print("streamlit is installed — launch the web UI with:\n"
                  "  streamlit run pde_solver_tpu_torch/app.py\n"
                  "Falling back to CLI chat.\n")
        except ImportError:
            print("streamlit not installed — using CLI chat "
                  "(python -m pde_solver_tpu_torch.app --cli).\n")
    from pde_solver_tpu_torch.agents.orchestrator import run_chat_loop
    asyncio.run(run_chat_loop())


if __name__ == "__main__":
    main()
