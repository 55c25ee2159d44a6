"""The benchmark's harness: the run (`bench`), the traffic generator
(`loop`), the trace's records and arithmetic (`trace`), the correctness
check (`check`), the card's peaks (`peaks`) and the readers' helpers
(`readers`)."""
