# Convenience targets; the native library also builds lazily on first
# use (mcmc_ammsb/native.py).

CXX ?= g++
CXXFLAGS ?= -O3 -march=native -std=c++17 -shared -fPIC

native: build/libmcmc_sampler.so

build/libmcmc_sampler.so: csrc/sampler.cpp
	mkdir -p build
	$(CXX) $(CXXFLAGS) $< -o $@

test:
	python -m pytest tests/ -x -q

bench:
	python bench.py

clean:
	rm -rf build .pytest_cache
	find . -name __pycache__ -type d -exec rm -rf {} +

.PHONY: native test bench clean
