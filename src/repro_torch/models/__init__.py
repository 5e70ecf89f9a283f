"""The LM face's models: dense GQA decoder-only stacks (``transformer``),
their layers and attention, and the ``Model`` facade."""
