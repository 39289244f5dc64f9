"""Mean seconds of a heat call outside its assembly and solve."""

from portbench.lib import readers


def read(run):
    return readers.tool_other_s(run)
