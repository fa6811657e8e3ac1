"""The drivers of the traffic mixes: each ``traffic/<mix>.json`` names one
(``objects``, ``rooms``), which makes the inputs, drives the
program through its entry and checks what it produced."""
