"""Minimal MCP (Model Context Protocol) stdio server + client of the port.

The reference exposes its solvers through FastMCP over stdio
(fenics_mcp_server.py:1899, :4554).  This package implements the same wire
protocol (JSON-RPC 2.0, newline-delimited, initialize / tools/list /
tools/call) from scratch, as the JAX package's ``mcp`` does, and serves the
port's 31 tools (the reference's 13 and 18 extensions) without third-party
MCP dependencies.
"""
