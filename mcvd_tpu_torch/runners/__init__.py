"""Training and evaluation orchestration: `runner.Runner`, `meters`, `plots`.
Nothing is imported here, so a plotting process that unpickles the meters
imports numpy and matplotlib, not torch."""
