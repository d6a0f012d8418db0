# Developer entry points (the reference ships Makefiles; ours is thin
# because the package is pure Python + an on-demand g++ native lib).

.PHONY: test bench native clean encode-corpus analyze-corpus smoke

test:
	python -m pytest tests/ -q

# On-card smoke run: every encode path at full width on one GPU, byte-
# checked against the host coder, plus the gpu-marked tests (one process).
smoke:
	python chip_smoke.py

bench:
	python bench.py

native:
	python -c "from jpegtpu import native; assert native.available(); print('native runtime OK')"

# Encode the reference corpus and analyze against the originals
# (the reference's run_analysis.sh workflow, end to end).
encode-corpus:
	mkdir -p out/corpus
	@for f in /root/reference/assets/input/*.bmp; do \
	  n=$$(basename $$f .bmp); \
	  python -m jpegtpu.cli encode $$f out/corpus/$$n.jpeg --stats; \
	done

analyze-corpus:
	python -m jpegtpu.cli analyze-dir /root/reference/assets/input out/corpus -d out/difference

clean:
	rm -rf out jpegtpu/native/_bitpack.so
