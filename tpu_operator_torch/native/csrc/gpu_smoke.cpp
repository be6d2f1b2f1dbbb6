// gpu-smoke: the nvidia-smi-shaped startup probe (native/tpu_smoke.cpp's
// counterpart). The driver DaemonSet's startupProbe runs it in place of
// `nvidia-smi`: it prints the chip table libgpuinfo gives and exits 0 when
// cards are visible, 2 when none are, 1 when the probe fails.
//
//   gpu_smoke [--dev-root DIR] [--json]

#include <cstdio>
#include <cstring>
#include <string>

extern "C" {
int gpuinfo_chip_count(const char* dev_root, const char* proc_root, const char* sysfs);
int gpuinfo_summary_json(const char* dev_root, const char* proc_root, const char* sysfs,
                         char* buf, int buf_len);
}

int main(int argc, char** argv) {
  const char* dev_root = "/dev";
  bool json = false;
  for (int i = 1; i < argc; ++i) {
    if (std::strcmp(argv[i], "--dev-root") == 0 && i + 1 < argc) {
      dev_root = argv[++i];
    } else if (std::strcmp(argv[i], "--json") == 0) {
      json = true;
    } else if (std::strcmp(argv[i], "--help") == 0) {
      std::printf("usage: gpu-smoke [--dev-root DIR] [--json]\n");
      return 0;
    }
  }

  std::string buf(16384, '\0');
  int rc;
  while ((rc = gpuinfo_summary_json(dev_root, nullptr, nullptr, &buf[0], (int)buf.size())) == -3 &&
         buf.size() < (1u << 26))
    buf.assign(buf.size() * 4, '\0');
  if (rc != 0) {
    std::fprintf(stderr, "gpu-smoke: probe failed (%d)\n", rc);
    return 1;
  }
  int n = gpuinfo_chip_count(dev_root, nullptr, nullptr);
  if (!json) std::printf("GPUs visible: %d\n", n);
  std::printf("%s\n", buf.c_str());
  return n > 0 ? 0 : 2;
}
