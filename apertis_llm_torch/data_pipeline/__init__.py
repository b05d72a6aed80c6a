"""The data pipeline (``apertis_llm_tpu/data_pipeline``): download, clean,
deduplicate and tokenize web text on the host, on a local process pool or
on Spark (``main.run_pipeline``). No stage runs on the card. It needs PyYAML
(``config``) and, for the tokenize stage, ``pyarrow``; ``requests``,
``bs4``, ``fasttext``, ``tokenizers``, ``transformers`` and ``pyspark`` are
imported only where a stage needs them. The modules are copies of the JAX
package's, whose package imports JAX."""
